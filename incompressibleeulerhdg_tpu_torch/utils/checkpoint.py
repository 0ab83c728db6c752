"""Checkpoint / resume of solver state.

The port's own copy of incompressibleeulerhdg_tpu/utils/checkpoint.py: the
same npz format byte for byte, so a checkpoint written by either package
loads in the other.  The full IMEX stage state (or plain (Q, p) state), the
time, and the defining configuration are saved atomically and validated on
load.
"""

import json
import os
import tempfile

import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint"]

_FORMAT_VERSION = 1


def save_checkpoint(path, state, t, config=None):
    """Atomically save a solver state pytree.

    :arg state: dict name -> array or list-of-arrays (e.g. stage states)
    :arg t: current simulation time
    :arg config: JSON-serialisable dict describing the run (mesh size,
        degree, scheme, dt, ...) — validated against on resume
    """
    arrays = {}
    meta = {"version": _FORMAT_VERSION, "t": float(t), "keys": {}, "config": config or {}}
    for name, value in state.items():
        if value is None:
            continue
        if isinstance(value, (list, tuple)):
            meta["keys"][name] = len(value)
            for i, v in enumerate(value):
                arrays[f"{name}__{i}"] = np.asarray(v)
        else:
            meta["keys"][name] = -1
            arrays[name] = np.asarray(value)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8
    )
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_checkpoint(path, expect_config=None):
    """Load a checkpoint; returns (state dict, t, config).

    :arg expect_config: if given, every key present must match the stored
        config (guards against resuming with a different mesh/scheme)
    """
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
        if meta["version"] != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {meta['version']}")
        if expect_config:
            for k, v in expect_config.items():
                stored = meta["config"].get(k)
                if stored != v:
                    raise ValueError(
                        f"checkpoint config mismatch for '{k}': stored {stored!r}, expected {v!r}"
                    )
        state = {}
        for name, n in meta["keys"].items():
            if n < 0:
                state[name] = z[name]
            else:
                state[name] = [z[f"{name}__{i}"] for i in range(n)]
    return state, meta["t"], meta["config"]

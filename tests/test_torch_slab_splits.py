"""Distributed steps of the PyTorch port on the other slab splits: an uneven
split (7 columns over 4 ranks: the last slab carries a dummy column) and
the periodic double shear layer (8^2 over 2 ranks, the wrap halo between
the last and the first rank), each with every slab-path scheme; the IMEX
tracer; checkpoint and resume of a distributed run.

Each is held to the port's single-rank run (float64, k=1): (Q, p) and the
tracer to 1e-10 relative after each of two steps, every Krylov solve the
same number of iterations.  The single-rank port is held to the JAX package
by tests/test_torch_slab_steps.py, test_torch_step.py, test_torch_dg.py,
test_torch_monolithic.py and test_torch_periodic.py.  Capped solves as in
tests/slab_jobs.py.
"""

import numpy as np
import pytest
import torch

from incompressibleeulerhdg_tpu_torch.parallel.launch import run_ranks
from incompressibleeulerhdg_tpu_torch.timesteppers.hdg_imex import (
    IncompressibleEulerHDGIMEXSSP2_332,
)
from incompressibleeulerhdg_tpu_torch.utils.checkpoint import load_checkpoint

import slab_jobs

torch.set_num_threads(1)

SCHEMES = ("imex", "monolithic", "hdg_implicit", "dg_implicit")
SPLITS = {
    "uneven": (4, tuple((s, "taylorgreen", 7) for s in SCHEMES)),
    "periodic": (2, tuple((s, "shear", 8) for s in SCHEMES) + (("imex_tracer", "taylorgreen", 8),)),
}
TIMEOUT = 300


def close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = float(np.max(np.abs(got - ref)))
    assert err <= rtol * float(np.max(np.abs(ref))), err


@pytest.fixture(scope="module", params=list(SPLITS))
def split(request, tmp_path_factory):
    n, runs = SPLITS[request.param]
    single = {r: slab_jobs.run_scheme(*r) for r in runs}
    dist = run_ranks(slab_jobs.job, n, args=(runs,), device="cpu", timeout=TIMEOUT,
                     rendezvous_dir=tmp_path_factory.mktemp("ranks"))
    return runs, single, dist


def _runs(split, kind):
    return [r for r in split[0] if (r[0] == "imex_tracer") == (kind == "tracer")]


@pytest.mark.parametrize("kind", ["schemes", "tracer"])
def test_distributed_steps_match_single_rank(split, kind):
    runs, single, dist = split
    for run in _runs(split, kind):
        got, ref = dist[0][run], single[run]
        assert got["counts"] == ref["counts"], run
        for a, b in zip(got["states"], ref["states"]):
            assert len(a) == len(b) == (3 if kind == "tracer" else 2)
            for x, y in zip(a, b):
                close(x, y, 1e-10)
        for per_rank in (o[run]["collectives"] for o in dist):
            assert per_rank == dist[0][run]["collectives"], run
            assert all(c["gather"] == 0 and c["halo"] > 0 for c in per_rank), run


def test_checkpoint_resume_roundtrip(tmp_path):
    """A distributed run checkpointed after one step and resumed (every rank
    reads its slab from the file) ends where the single-rank run ends after
    two steps; the distributed checkpoint holds the single-rank run's state
    in the single-device file format."""
    path = str(tmp_path / "dist.npz")
    out = run_ranks(slab_jobs.checkpoint_job, 2, args=(path,), device="cpu",
                    timeout=TIMEOUT, rendezvous_dir=tmp_path)[0]
    ref = slab_jobs.run_scheme("imex", "taylorgreen", 8)["states"]
    for x, y in zip(out[1], ref[1]):
        close(x, y, 1e-10)
    stepper, prob, dt, _ = slab_jobs.make("imex", "taylorgreen", 8)
    assert isinstance(stepper, IncompressibleEulerHDGIMEXSSP2_332)
    stepper.solve(*prob.initial_condition(), None, prob.f_rhs(), dt, checkpoint_every=1,
                  checkpoint_path=str(tmp_path / "single.npz"))
    got, t_got, cfg_got = load_checkpoint(path)
    want, t_want, cfg_want = load_checkpoint(str(tmp_path / "single.npz"))
    assert (t_got, cfg_got) == (t_want, cfg_want) and got.keys() == want.keys()
    for key in want:
        for x, y in zip(got[key], want[key]):
            assert x.dtype == y.dtype
            if np.abs(y).max() > 0:
                close(x, y, 1e-10)

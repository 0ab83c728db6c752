"""The partitioned disk through the port's CLI against the JAX package's
single-device run of the same flags, on the CPU in float64.

``--problem kelvinhelmholtz --refinement 2 --use_projection_method``, two
SSP2(3,3,2) steps: the port over 2 ranks (the cell/facet partition, gloo)
prints the JAX driver's averaged iteration counts, and its checkpoint after
the last step (every stage state, gathered to rank 0) equals the JAX run's
to 1e-10.  (tests/test_sharding.py holds the JAX package's GSPMD run to the
same single-device run.)
"""

import pytest
import torch

from incompressibleeulerhdg_tpu.cli import driver as jdriver

from incompressibleeulerhdg_tpu_torch.cli import driver as tdriver
from incompressibleeulerhdg_tpu_torch.utils.checkpoint import load_checkpoint
from incompressibleeulerhdg_tpu_torch.utils.diagnostics import averaged_counts

from test_torch_disk import close

torch.set_num_threads(1)


def test_partitioned_disk_cli_matches_jax_single_device(tmp_path, monkeypatch, capfd):
    monkeypatch.chdir(tmp_path)
    argv = ["--problem", "kelvinhelmholtz", "--refinement", "2", "--degree", "1", "--dt", "0.05",
            "--tfinal", "0.1", "--use_projection_method", "--checkpoint_every", "1",
            "--checkpoint_file", "state.npz"]
    capfd.readouterr()
    res = tdriver.main(argv + ["--n_devices", "2", "--device", "cpu"])
    out = capfd.readouterr().out  # rank 0 prints from its own process
    assert "distributed over 2 devices" in out
    (tmp_path / "state.npz").rename(tmp_path / "port.npz")
    jdriver.main(argv)
    jout = capfd.readouterr().out
    counts, jcounts = averaged_counts(out), averaged_counts(jout)
    assert len(counts) == 4 and counts == jcounts, (counts, jcounts)
    (state, t, _), (jstate, jt, _) = (load_checkpoint(tmp_path / f) for f in ("port.npz",
                                                                               "state.npz"))
    assert t == pytest.approx(jt, abs=1e-12) and state.keys() == jstate.keys()
    for name, ref in jstate.items():
        for a, b in zip(*((v if isinstance(v, list) else [v]) for v in (state[name], ref))):
            close(a, b, 1e-10)
    assert bool(torch.isfinite(res["Q"]).all())

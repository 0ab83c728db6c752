"""The slab decomposition of the PyTorch port (``--n_devices``), its tables
and its process model, against the JAX package's ``parallel/slab.py``.

- the port's per-rank tables equal the JAX ``SlabDecomposition``'s per-slab
  tables built from the same mesh (maps, masks, local geometry, the
  condensed system's S, Sdiag_inv and null vector, the BDM class ids, the
  GTMG's vertex-canvas groups), on even, uneven and periodic splits, read
  through ``convert.slab_decomposition_from_jax`` (no JAX compile);
- a distributed step moves only halo rows and sums (no gather), and each
  rank holds about 1/N of the cell and facet tables;
- the launcher: a failing rank fails the run (no hang), ``--device cuda``
  needs a card per rank;
- the CLI: ``--n_devices 2 --device cpu`` prints the JAX driver's lines and
  the single-rank run's errors.

Ranks are gloo processes on the CPU (one thread each) meeting through a
file under ``tmp_path``; every launch carries a timeout, so a hang fails
its test instead of stalling the suite.
"""

import numpy as np
import pytest
import torch

from incompressibleeulerhdg_tpu.fem.discretisation import HDGDiscretisation as JDisc
from incompressibleeulerhdg_tpu.mesh import generators as JM
from incompressibleeulerhdg_tpu.parallel.slab import build_slab_decomposition
from incompressibleeulerhdg_tpu.timesteppers.hdg_imex import (
    IncompressibleEulerHDGIMEXSSP2_332 as JSSP2,
)

from incompressibleeulerhdg_tpu_torch import convert
from incompressibleeulerhdg_tpu_torch.cli import driver as tdriver
from incompressibleeulerhdg_tpu_torch.fem.discretisation import HDGDiscretisation as TDisc
from incompressibleeulerhdg_tpu_torch.mesh import generators as TM
from incompressibleeulerhdg_tpu_torch.models.problems import TaylorGreen
from incompressibleeulerhdg_tpu_torch.parallel.launch import run_ranks
from incompressibleeulerhdg_tpu_torch.parallel.slab import SlabDecomposition
from incompressibleeulerhdg_tpu_torch.timesteppers.hdg_imex import (
    IncompressibleEulerHDGIMEXSSP2_332 as TSSP2,
)

torch.set_num_threads(1)

TIMEOUT = 120  # seconds for one launch of the ranks

SPLITS = {"even": ("square", 8, 2), "uneven": ("square", 7, 4), "periodic": ("periodic", 8, 4)}


def _mesh(pkg, kind, nx):
    return pkg.unit_square_mesh(nx) if kind == "square" else pkg.periodic_square_mesh(nx)


@pytest.mark.parametrize("split", SPLITS)
def test_tables_match_jax(split):
    kind, nx, n = SPLITS[split]
    jd = JDisc(_mesh(JM, kind, nx), 1)
    jdec = build_slab_decomposition(jd, JSSP2(jd, 0.1), n)
    td = TDisc(_mesh(TM, kind, nx), 1, device="cpu")
    ts = TSSP2(td, 0.1)
    for rank in range(n):
        dec = SlabDecomposition(td, ts, n, rank)
        ref = convert.slab_decomposition_from_jax(jdec, rank)
        for got, want in ((dec.cell_maps[rank], ref["cell_map"]),
                          (dec.facet_maps[rank], ref["facet_map"]),
                          (dec.cell_valid[rank], ref["cell_valid"]),
                          (dec.facet_valid[rank], ref["facet_valid"])):
            np.testing.assert_array_equal(got, want)
        for name in ("det_jac", "jac_inv", "normal", "flen", "hF_inv", "ftab", "cfside",
                     "cfsign", "cf_tab", "cf_bnd", "xq", "xnodes1", "xnodes0", "fint",
                     "fvalid", "cvalid"):
            a, b = getattr(dec.geom, name), getattr(ref["geom"], name)
            if a is None or b is None:
                assert a is None and b is None, name
                continue
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-14, atol=0, err_msg=name)
        for name in ("n_int", "fcol_bounds", "fcol_orphans", "uniform"):
            assert getattr(dec.geom, name) == getattr(ref["geom"], name), name
        assert dec.geom.shift[:6] == ref["geom"].shift[:6]
        assert dec.geom.shift[6][1] == n
        for name in ("S", "Sdiag_inv", "nullvec", "class_id"):
            np.testing.assert_allclose(getattr(dec.cs, name).numpy(),
                                       getattr(ref["cs"], name).numpy(), rtol=1e-13, atol=1e-15,
                                       err_msg=name)
        np.testing.assert_array_equal(dec.proj.class_id.numpy(), ref["proj"].class_id.numpy())
        assert dec.pc.dist[1:] == ref["pc"].dist[1:]
        for name in ("coarse_eig_inv", "trace_nodes"):
            np.testing.assert_allclose(getattr(dec.pc, name).numpy(),
                                       getattr(ref["pc"], name).numpy(), rtol=1e-14)


def test_tables_are_partitioned():
    """Each rank's cell and facet tables hold its slab's share: about 1/N of
    the single-device tables (the boundary families add a little)."""
    td = TDisc(TM.unit_square_mesh(16), 1, device="cpu")
    ts = TSSP2(td, 0.1)
    whole = SlabDecomposition(td, ts, 1, 0).table_bytes()
    for n in (2, 4):
        parts = [SlabDecomposition(td, ts, n, r).table_bytes() for r in range(n)]
        assert all(0.9 / n < b / whole < 1.15 / n for b in parts), (n, parts, whole)


def _collective_job(comm, device):
    """One IMEX step on this rank's slab with the collectives counted."""
    disc = TDisc(TM.unit_square_mesh(8), 1, device="cpu")
    stepper = TSSP2(disc, 0.1)
    problem = TaylorGreen(disc)
    stepper.distribute(comm, device)
    state = stepper.initial_state(*problem.initial_condition())
    comm.reset_counts()
    stepper.step(*state, 0.0, problem.f_rhs())
    step = dict(comm.counts)
    comm.reset_counts()
    stepper.gather(state[0][0])
    return step, dict(comm.counts), stepper.dec.table_bytes()


def test_step_moves_only_halos_and_sums(tmp_path):
    out = run_ranks(_collective_job, 2, device="cpu", timeout=TIMEOUT,
                    rendezvous_dir=tmp_path)
    for step, gather, _ in out:
        assert step["gather"] == 0 and step["halo"] > 0 and step["allreduce"] > 0, step
        assert gather == {"halo": 0, "ghosts": 0, "allreduce": 0, "gather": 1}
    assert out[0][0] == out[1][0]  # the ranks took the same path


def _failing_job(comm, device):
    if comm.rank == 1:
        raise ValueError("rank 1 fails")
    comm.allreduce(torch.ones(1))  # rank 0 waits for rank 1 here
    return comm.rank


def test_a_failing_rank_fails_the_run(tmp_path):
    with pytest.raises(Exception, match="rank 1 fails"):
        run_ranks(_failing_job, 2, device="cpu", timeout=TIMEOUT, rendezvous_dir=tmp_path)


def _sleeping_job(comm, device):
    import time

    time.sleep(60)


def test_launch_timeout_ends_the_ranks(tmp_path):
    with pytest.raises(TimeoutError):
        run_ranks(_sleeping_job, 2, device="cpu", timeout=5, rendezvous_dir=tmp_path)


def test_cuda_needs_a_card_per_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="only 1 CUDA devices"):
        run_ranks(_failing_job, 2, device="cuda")


def test_cli_n_devices_prints_the_driver_lines(tmp_path, monkeypatch, capfd):
    monkeypatch.chdir(tmp_path)
    argv = ["--nx", "8", "--degree", "1", "--dt", "0.1", "--tfinal", "0.2",
            "--use_projection_method", "--device", "cpu"]
    single = tdriver.main(argv)
    capfd.readouterr()
    res = tdriver.main(argv + ["--n_devices", "2"])
    out = capfd.readouterr().out
    for line in ("model problem = taylorgreen", "mesh size = 8 x 8",
                 "distributed over 2 devices", "average number of solver iterations",
                 "velocity error = ", "pressure error = ", "wrote solution.vtu"):
        assert out.count(line) == 1, (line, out)
    assert (tmp_path / "solution.vtu").exists()
    counts = lambda r: [{k: v for k, v in c.items() if k != "max_relres"} for c in r["step_counts"]]
    assert counts(res) == counts(single)
    for key in ("velocity_error", "pressure_error"):
        assert abs(res[key] - single[key]) <= 1e-10 * single[key], key
    assert float((res["Q"] - single["Q"]).abs().max()) <= 1e-10


def test_cli_n_devices_pressure_solver_benchmark(tmp_path, monkeypatch):
    """``--test_pressure_solver`` over 2 ranks solves the single-rank run's
    seeded system in as many iterations."""
    monkeypatch.chdir(tmp_path)
    argv = ["--nx", "8", "--degree", "1", "--device", "cpu", "--test_pressure_solver"]
    single = tdriver.main(argv)
    res = tdriver.main(argv + ["--n_devices", "2"])
    assert res["iterations"] == single["iterations"] > 0

"""The cell/facet partition of the PyTorch port (parallel/partition.py) rank
by rank, on the CPU in float64 over gloo.

On the unit disk (refinement 2, k = 1) split 2 and 3 ways and on the unit
square (nx = 3, k = 1) split 4 ways:

- every cell and every facet is owned by exactly one rank, a facet by the
  owner of its plus cell, and every gather table of a rank reads only its
  own entries and its ghosts;
- after ``Comm.ghosts`` the ghost entries of every plan (cells, facets,
  vertex-star facets) equal the global array at their ids;
- one partitioned trace matvec, GTMG application, tentative matvec and
  symmetric colored sweep, gathered, equal the global ones to 1e-12 (the
  counterpart of tests/test_sharding.py::
  test_sharded_operators_match_single_device).
"""

import numpy as np
import pytest
import torch

from incompressibleeulerhdg_tpu_torch.parallel.launch import run_ranks
from incompressibleeulerhdg_tpu_torch.parallel.partition import Partition

import partition_jobs

torch.set_num_threads(1)

CASES = {
    "disk_2ranks": (("kelvinhelmholtz", 2, "imex", 0.05, 1, False), 2),
    "disk_3ranks": (("kelvinhelmholtz", 2, "imex", 0.05, 1, False), 3),
    "square_4ranks": (("taylorgreen", 3, "imex", 0.1, 1, False), 4),
}
TIMEOUT = 120


def close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = float(np.max(np.abs(got - ref)))
    assert err <= rtol * float(np.max(np.abs(ref))), err


@pytest.mark.parametrize("name", list(CASES))
def test_ownership_and_tables(name):
    case, n = CASES[name]
    stepper, _ = partition_jobs.make(case)
    mesh = stepper.disc.mesh
    parts = [Partition(stepper.disc, stepper, n, r) for r in range(n)]
    cells = np.sort(np.concatenate(parts[0].cell_maps))
    facets = np.sort(np.concatenate(parts[0].facet_maps))
    assert np.array_equal(cells, np.arange(mesh.n_cells))
    assert np.array_equal(facets, np.arange(mesh.n_facets))
    for r, dec in enumerate(parts):
        assert np.array_equal(dec.cell_maps[r], parts[0].cell_maps[r])
        owner = dec.cell_owner[mesh.facet_cells[dec.facet_maps[r], 0]]
        assert np.all(owner == r)  # a facet goes with its plus cell
        g = dec.geom
        nce, nfe = dec.cell_plan.n_ext, dec.facet_plan.n_ext
        assert g.n_cells == dec.cell_plan.n_owned and g.n_facets == dec.facet_plan.n_owned
        assert 0 <= int(g.fcells.min()) and int(g.fcells.max()) < nce
        assert 0 <= int(g.cell_facets.min()) and int(g.cell_facets.max()) < nfe
        assert int(g.cfassemble.max()) < 2 * nfe
        # ghosts are other ranks' entries, grouped by owner
        for plan, own in ((dec.cell_plan, dec.cell_owner), (dec.facet_plan, dec.facet_owner)):
            o = own[plan.ghost_ids]
            assert np.all(o != r) and np.all(np.diff(o) >= 0)
            assert [p for p, _ in plan.recv] == sorted(set(o.tolist()))
        # the local fcells read the same cells as the global table
        fm = dec.facet_maps[r]
        ids = np.concatenate([dec.cell_maps[r], dec.cell_plan.ghost_ids])
        glob = np.asarray(mesh.facet_cells[fm, 0])
        assert np.array_equal(ids[g.fcells[0].numpy()], glob)
        n_int = int(g.n_int)
        inner = mesh.facet_cells[fm[:n_int], 1]
        assert np.array_equal(ids[g.fcells[1, :n_int].numpy()], inner)
        assert np.all(fm[:n_int] < mesh.n_interior_facets)
        assert np.all(fm[n_int:] >= mesh.n_interior_facets)


@pytest.mark.parametrize("name", list(CASES))
def test_ghosts_and_operators_match_global(name, tmp_path):
    case, n = CASES[name]
    out = run_ranks(partition_jobs.operator_job, n, args=(case,), device="cpu",
                    timeout=TIMEOUT, rendezvous_dir=tmp_path)[0]
    assert out["ghosts"] and all(out["ghosts"].values()), out["ghosts"]
    if case[0] == "kelvinhelmholtz":
        assert "star" in out["ghosts"]  # the vertex-star smoother's plan
    ref = partition_jobs.global_operators(case)
    for key in ("trace_matvec", "gtmg", "tentative_matvec", "sweep"):
        close(out[key], ref[key], 1e-12)

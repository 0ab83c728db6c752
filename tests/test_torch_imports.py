"""The PyTorch port stands on its own: importing it pulls in no JAX and
nothing of the JAX package, builds nothing, and ``chip_smoke.py`` refuses to
report a result without a card or outside a checkout of the repository."""

import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_MODULES = [
    "incompressibleeulerhdg_tpu_torch",
    "incompressibleeulerhdg_tpu_torch.kernels",
    "incompressibleeulerhdg_tpu_torch.convert",
    "incompressibleeulerhdg_tpu_torch.mesh",
    "incompressibleeulerhdg_tpu_torch.mesh.generators",
    "incompressibleeulerhdg_tpu_torch.mesh.triangle_mesh",
    "incompressibleeulerhdg_tpu_torch.mesh.native",
    "incompressibleeulerhdg_tpu_torch.fem.quadrature",
    "incompressibleeulerhdg_tpu_torch.fem.lagrange",
    "incompressibleeulerhdg_tpu_torch.fem.spaces",
    "incompressibleeulerhdg_tpu_torch.fem.discretisation",
    "incompressibleeulerhdg_tpu_torch.fem.cg",
    "incompressibleeulerhdg_tpu_torch.ops.structured",
    "incompressibleeulerhdg_tpu_torch.ops.fields",
    "incompressibleeulerhdg_tpu_torch.ops.forms",
    "incompressibleeulerhdg_tpu_torch.ops.projection",
    "incompressibleeulerhdg_tpu_torch.ops.reconstruction",
    "incompressibleeulerhdg_tpu_torch.ops.rt",
    "incompressibleeulerhdg_tpu_torch.ops.tracer",
    "incompressibleeulerhdg_tpu_torch.ops.vorticity",
    "incompressibleeulerhdg_tpu_torch.models.problems",
    "incompressibleeulerhdg_tpu_torch.linalg.condense",
    "incompressibleeulerhdg_tpu_torch.linalg.krylov",
    "incompressibleeulerhdg_tpu_torch.linalg.gtmg",
    "incompressibleeulerhdg_tpu_torch.linalg.pressure",
    "incompressibleeulerhdg_tpu_torch.linalg.smallinv",
    "incompressibleeulerhdg_tpu_torch.linalg.preconditioners",
    "incompressibleeulerhdg_tpu_torch.linalg.tentative",
    "incompressibleeulerhdg_tpu_torch.timesteppers.tableaus",
    "incompressibleeulerhdg_tpu_torch.timesteppers.common",
    "incompressibleeulerhdg_tpu_torch.timesteppers.hdg_imex",
    "incompressibleeulerhdg_tpu_torch.timesteppers.hdg_implicit",
    "incompressibleeulerhdg_tpu_torch.timesteppers.dg_implicit",
    "incompressibleeulerhdg_tpu_torch.timesteppers.conforming_implicit",
    "incompressibleeulerhdg_tpu_torch.linalg.monolithic",
    "incompressibleeulerhdg_tpu_torch.parallel",
    "incompressibleeulerhdg_tpu_torch.parallel.comm",
    "incompressibleeulerhdg_tpu_torch.parallel.slab",
    "incompressibleeulerhdg_tpu_torch.parallel.launch",
    "incompressibleeulerhdg_tpu_torch.cli.driver",
    "incompressibleeulerhdg_tpu_torch.tools.microbench_gj",
    "incompressibleeulerhdg_tpu_torch.tools.ab_cross_patch",
    "incompressibleeulerhdg_tpu_torch.tools.tune_gj",
    "incompressibleeulerhdg_tpu_torch.tools.jax_reference",
    "incompressibleeulerhdg_tpu_torch.tools.fault_readings",
    "incompressibleeulerhdg_tpu_torch.utils.logging",
    "incompressibleeulerhdg_tpu_torch.utils.checkpoint",
    "incompressibleeulerhdg_tpu_torch.utils.vtk",
    "incompressibleeulerhdg_tpu_torch.utils.diagnostics",
    "incompressibleeulerhdg_tpu_torch.utils.callbacks",
    "incompressibleeulerhdg_tpu_torch.utils.grid",
    "chip_smoke",
]


def _run(code, cwd=ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=300)


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'incompressibleeulerhdg_tpu'))\n"
        "assert not bad, bad\n"
        "from incompressibleeulerhdg_tpu_torch import kernels\n"
        "from incompressibleeulerhdg_tpu_torch.mesh import native\n"
        "assert not kernels._LIBS, 'a kernel was built at import'\n"
        "assert native._LIB is None, 'the mesh kernel was loaded at import'\n"
        "print('ok')\n"
    )
    res = _run(code)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_port_source_names_no_jax():
    """No module of the port and not chip_smoke.py imports jax or anything of
    the JAX package, even lazily."""
    refused = ("jax", "incompressibleeulerhdg_tpu")
    paths = [*(ROOT / "incompressibleeulerhdg_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]
    for path in paths:
        for line in path.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] == ["import"]:
                names = words[1:]
            elif words[:1] == ["from"]:
                names = words[1:2]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in refused, f"{path}: {line.strip()}"


def _assert_refused(res):
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the smoke test would run for real")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    _assert_refused(res)
    assert "cuda" in res.stdout.lower()


def test_chip_smoke_refuses_outside_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    _assert_refused(res)


def test_wrappers_raise_off_cpu_and_cuda():
    """Off the CPU a wrapper launches its kernel or raises: a tensor on any
    other device never reaches the plain version."""
    from incompressibleeulerhdg_tpu_torch.linalg import preconditioners as P
    from incompressibleeulerhdg_tpu_torch.linalg import smallinv

    A = torch.empty(6, 6, 10, device="meta")
    Pm = torch.empty(1, 12, 12, device="meta")
    x = torch.empty(12, 10, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        P.fact_apply(A, Pm, (0, 10), x)
    with pytest.raises(ValueError, match="CUDA"):
        P.cross_pair(A, A, Pm, Pm, (0, 10), x, x)
    D = torch.empty(12, 12, 10, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        P.patch_solve(D, D, A, A, Pm[0], Pm[0], x, x, 0)
    with pytest.raises(ValueError, match="CUDA"):
        smallinv.gauss_jordan_inv_bl(D)


def test_kernel_build_needs_nvcc():
    from incompressibleeulerhdg_tpu_torch import kernels

    if shutil.which("nvcc") or pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is installed here")
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build_all()
    assert set(kernels.LAUNCHES) == set(kernels.KERNELS)
    kernels.LAUNCHES["fact_apply"] += 3
    kernels.reset_launches()
    assert all(v == 0 for v in kernels.LAUNCHES.values())

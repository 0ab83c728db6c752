"""The PyTorch port stands on its own: importing it pulls in no JAX, builds
nothing, and ``chip_smoke.py`` refuses to report a result without a card or
outside a checkout of the repository."""

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
    "incompressibleeulerhdg_tpu_torch.fem.discretisation",
    "incompressibleeulerhdg_tpu_torch.ops.structured",
    "incompressibleeulerhdg_tpu_torch.ops.fields",
    "incompressibleeulerhdg_tpu_torch.ops.forms",
    "incompressibleeulerhdg_tpu_torch.ops.projection",
    "incompressibleeulerhdg_tpu_torch.ops.reconstruction",
    "incompressibleeulerhdg_tpu_torch.models.problems",
    "incompressibleeulerhdg_tpu_torch.linalg.condense",
    "incompressibleeulerhdg_tpu_torch.linalg.krylov",
    "incompressibleeulerhdg_tpu_torch.linalg.gtmg",
    "incompressibleeulerhdg_tpu_torch.linalg.pressure",
    "incompressibleeulerhdg_tpu_torch.linalg.smallinv",
    "incompressibleeulerhdg_tpu_torch.linalg.preconditioners",
    "incompressibleeulerhdg_tpu_torch.linalg.tentative",
    "incompressibleeulerhdg_tpu_torch.timesteppers.common",
    "incompressibleeulerhdg_tpu_torch.timesteppers.hdg_imex",
    "incompressibleeulerhdg_tpu_torch.timesteppers.hdg_implicit",
    "incompressibleeulerhdg_tpu_torch.linalg.monolithic",
    "incompressibleeulerhdg_tpu_torch.cli.driver",
    "incompressibleeulerhdg_tpu_torch.tools.microbench_gj",
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
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "from incompressibleeulerhdg_tpu_torch import kernels\n"
        "assert not kernels._LIBS, 'a kernel was built at import'\n"
        "print('ok')\n"
    )
    res = _run(code)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_port_source_names_no_jax():
    """No module of the port imports jax, even lazily."""
    for path in (ROOT / "incompressibleeulerhdg_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            assert not (words[:1] == ["import"] and words[1:2] == ["jax"]), path
            assert not (words[:1] == ["from"] and words[1:2] and
                        words[1].split(".")[0] == "jax"), path


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

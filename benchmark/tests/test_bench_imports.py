"""No benchmark run loads JAX or the JAX package, checked by whole top-level
names (``incompressibleeulerhdg_tpu_torch`` is the program and allowed)."""

import subprocess
import sys
import textwrap

from benchmark import manifest, run


def test_check_compares_whole_top_level_names(monkeypatch):
    fake = {"incompressibleeulerhdg_tpu_torch.kernels": 0, "jaxtyping": 0, "numpy": 0}
    monkeypatch.setattr(sys, "modules", dict(fake))
    assert run.jax_modules() == []
    for name in ("jax", "jaxlib.xla_client", "flax.linen", "incompressibleeulerhdg_tpu.mesh"):
        monkeypatch.setattr(sys, "modules", dict(fake, **{name: 0}))
        assert run.jax_modules() == [name.split(".")[0]]


def test_a_run_loads_no_jax():
    """A tiny CPU run of every benchmark module in a fresh interpreter; the
    readers are loaded too."""
    code = textwrap.dedent("""
        import sys, torch
        from benchmark import manifest, run, control, probe, trace, roofline, reference, cell
        spec = manifest.cell_spec("tg-k2-512")
        spec.traffic = dict(spec.traffic, nx=4, dt=0.125)
        run.TRACE_STEPS = 1
        run.run_cell(spec, 5, 0.0, 1, torch.device("cpu"))
        print(run.jax_modules())
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"

"""A run's result line, the trace reading and the readers, on the CPU at a
tiny size (the card's numbers come only from the card)."""

import json
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark import manifest, run
from benchmark.trace import LAUNCH_SPAN, WINDOW_SPAN, summarise

TOP = {"correct", "attempted", "failed", "metrics", "device"}


def tiny_spec():
    """The 512^2 cell at 8^2, held to this size's limits (those of
    test_bench_faults.py)."""
    spec = manifest.cell_spec("tg-k2-512")
    spec.traffic = dict(spec.traffic, nx=8, dt=1 / 16)
    spec.limits = {"velocity_l2": 1.2e-4, "pressure_l2": 6e-4, "trace_rms": 6e-4,
                   "failed_steps": 0}
    return spec


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(trace, monkeypatch):
    monkeypatch.setattr(run, "TRACE_STEPS", 1)
    spec = tiny_spec()
    result, checks, notes = run.run_cell(spec, 2 ** 31 + 11, 0.0, trace, torch.device("cpu"))
    line = json.loads(json.dumps(result))
    assert TOP <= set(line) and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["checks"]) == set(spec.limits) | {"max_relres"}
    assert line["checks"]["max_relres"]["limit"] == spec.config["krylov_relres_max"]
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    units = {m["name"]: m["unit"] for m in spec.end_to_end + spec.per_layer}
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name] and isinstance(m["value"], float)
    if trace:
        # on the CPU the readers of spans and counters read; the trace's do not
        host = {"setup.mesh_s", "setup.disc_s", "phase_ms.build", "phase_ms.sweep",
                "tent_its_per_step", "pres_its_per_step"}
        assert set(line["metrics"]) == host
    else:
        assert set(line["metrics"]) == {m["name"] for m in spec.end_to_end}
    assert any(n.startswith("# window:") for n in notes)


def test_seed_draws_kappa_in_range_and_repeats():
    spec = tiny_spec()
    lo, hi = spec.traffic["kappa"]
    ks = [spec.problem.parameters(s, spec.traffic)["kappa"] for s in (0, 1, 2 ** 31 + 5, 2 ** 40)]
    assert all(lo <= k <= hi for k in ks) and len(set(ks)) == 4
    assert spec.problem.kappa_of(2 ** 31 + 5, (lo, hi)) == ks[2]


def _counts(relres, its=3):
    return {"tentative": [its] * 4, "pressure": [its] * 4, "final_pressure": its,
            "reconstruction": its, "max_relres": relres}


def test_a_step_over_the_stated_residual_fails():
    spec = tiny_spec()
    top = spec.config["krylov_relres_max"]
    sound = [_counts(0.9 * top), _counts(top)]
    bad = [_counts(1.01 * top), _counts(float("nan")), _counts(1e-6, its=0), _counts(1e-6)]
    assert run._failed(sound, top) == 0 and run._failed(bad, top) == 3
    spec.problem = SimpleNamespace(errors=lambda *a: dict.fromkeys(spec.limits, 0.0))
    checks = run.check_state(spec, {}, sound, None, 0.0, [])
    assert checks["max_relres"] == {"value": top, "limit": top}
    assert checks["failed_steps"]["value"] == 0
    checks = run.check_state(spec, {}, bad, None, 0.0, [])
    assert checks["max_relres"]["value"] == float("inf")
    assert checks["failed_steps"]["value"] == 3


def test_main_without_a_card_prints_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "tg-k2-512", "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(manifest.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(manifest.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "tg-k2-512",
                           "--seed", "3", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "{" not in proc.stdout


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic_trace():
    """A window of 100 us: a port launch (span 10-20, runtime call at 12,
    kernel 30-50) and a PyTorch op (runtime at 25, kernel 50-60); the host
    waits in a synchronise from 60 to 100."""
    return [
        _x("user_annotation", WINDOW_SPAN, 0, 100),
        _x("user_annotation", LAUNCH_SPAN + "0", 10, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 12, 2, corr=7),
        _x("cpu_op", "aten::mul", 24, 4),
        _x("cuda_runtime", "cudaLaunchKernel", 25, 2, corr=8),
        _x("cuda_runtime", "cudaDeviceSynchronize", 60, 40),
        _x("kernel", "patch_solve_kernel<float>", 30, 20, tid=7, corr=7),
        _x("kernel", "elementwise_kernel", 50, 10, tid=7, corr=8),
    ]


def test_trace_summary_attributes_device_time():
    s = summarise(synthetic_trace())
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(30e-6)
    assert s.launch_s == {0: pytest.approx(20e-6)}
    assert s.other_s == pytest.approx(10e-6)
    assert s.device_ops[0][0].startswith("port: patch_solve_kernel")
    gaps = dict(s.idle_gaps)
    assert gaps["cudaDeviceSynchronize"] == pytest.approx(40e-6)
    assert gaps["(Python between ops)"] == pytest.approx(30e-6)
    assert sum(gaps.values()) == pytest.approx(70e-6)
    assert summarise([e for e in synthetic_trace() if e["cat"] != "kernel"]) is None


def test_trace_readers():
    spec = tiny_spec()
    rec = type("Rec", (), {})()
    rec.trace = summarise(synthetic_trace())
    rec.trace_steps = 1
    rec.launches = [dict(name="patch_solve", dtype="float32", d1=10, m=65280, nseg=1,
                         factors="float32")]
    read = {name: spec.readers[name].read(rec) for name in
            ("kernel_roofline", "kernel_ms_per_step", "torch_ms_per_step", "device_ms_per_step")}
    assert read["kernel_ms_per_step"] == pytest.approx(0.02)
    assert read["torch_ms_per_step"] == pytest.approx(0.01)
    assert read["device_ms_per_step"] == pytest.approx(0.03)
    assert read["kernel_roofline"] == pytest.approx(100 * 0.0842e-3 / 20e-6, rel=1e-3)
    rec.launches = [dict(name="some_new_kernel")]
    assert spec.readers["kernel_roofline"].read(rec) is None
    rec.trace = None
    assert all(spec.readers[n].read(rec) is None for n in read)

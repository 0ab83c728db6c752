"""One run of one cell of the benchmark of ``incompressibleeulerhdg_tpu_torch``.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for.  The run

1. sets up the cell (``cell.set_up``): the configuration's HDG IMEX stepper
   on the traffic's mesh, the state of the traffic's problem
   (``problems/<problem>.py``) with the parameters that the seed draws,
   and one warm-up step; the kernels build into ``build/torch_kernels/``
   in the checkout on the first run there and load from it afterwards.
   ``setup_s`` runs from the start of this module to the end of the
   warm-up step;
2. steps back to back for ``--seconds`` (each step ended by a
   synchronise).  With ``--trace 0`` it reports the cell's end-to-end
   metrics.  With ``--trace 1`` the first ``TRACE_STEPS`` steps run under
   torch.profiler with every port kernel launch recorded (``probe.py``),
   the rest under the program's phase spans, and it reports the cell's
   per-layer metrics, each from its reader in ``metrics/``;
3. once the window has closed and the peak memory is read, frees the
   program's state and holds it to the plain reference (the problem's
   ``errors``, ``reference.py``) and to the configuration's largest Krylov
   residual: each number compared is printed beside its limit
   on standard error, last, and under ``checks`` at the end of the result.

The last line of standard output is the JSON result.  The run exits 2
without a result when the card is missing, and 3 when ``jax``, ``jaxlib``,
``flax`` or the JAX package ``incompressibleeulerhdg_tpu`` is loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import torch  # noqa: E402

from . import cell as C  # noqa: E402
from . import manifest  # noqa: E402
from .probe import LaunchRecorder  # noqa: E402
from .trace import WINDOW_SPAN, summarise_file  # noqa: E402

JAX_NAMES = frozenset({"jax", "jaxlib", "flax", "incompressibleeulerhdg_tpu"})
TRACE_STEPS = 3  # steps of the traced run under torch.profiler

__all__ = ["run_cell", "check_state", "main", "jax_modules", "TRACE_STEPS"]


def jax_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & JAX_NAMES)


def _relres(c):
    r = float(c["max_relres"])
    return r if math.isfinite(r) else math.inf


def _failed(counts, relres_max):
    """Steps whose largest Krylov relative residual is not finite or above
    ``relres_max``, or that made a solve of no iteration."""
    bad = 0
    for c in counts:
        its = list(c["tentative"]) + list(c["pressure"]) + \
            [c["final_pressure"], c["reconstruction"]]
        bad += _relres(c) > relres_max or min(its) <= 0
    return bad


def _card_line(device):
    if device.type != "cuda":
        return "# card: none (CPU run)"
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
        limit = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        limit = "not read"
    return (f"# card: {torch.cuda.get_device_name(device)} | nvidia-smi: {limit} | torch "
            f"{torch.__version__} cuda {torch.version.cuda} | tf32 "
            f"{torch.backends.cuda.matmul.allow_tf32}")


def _traced_window(cell, seconds, trace_steps):
    """The traced run's window: ``trace_steps`` steps under the profiler,
    then the program's phase spans until ``seconds`` have passed."""
    from incompressibleeulerhdg_tpu_torch.utils.logging import PerformanceLog

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cell.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with LaunchRecorder() as recorder, torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            _, counts, times = C.run_steps(cell, math.inf, max_steps=trace_steps)
    PerformanceLog.reset()
    _, counts2, times2 = C.run_steps(cell, seconds - (time.perf_counter() - t0),
                                     phase_timing=True)
    phases = {k: list(v) for k, v in PerformanceLog.data.items()}
    return prof, recorder.launches, counts, counts2, times + times2, phases


def _summarise(prof, notes):
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        notes.append(f"# trace: {os.path.getsize(path)} bytes of chrome trace")
        return summarise_file(path)


def check_state(spec, params, counts, arrays, t_final, notes):
    """Each number that decides ``correct`` beside its limit: the plain
    reference's distances of the state ``arrays`` (``cell.state_arrays``)
    at ``t_final`` (limits from the workload's file), the largest Krylov
    relative residual of the window (limit: the configuration's
    ``krylov_relres_max``), and the steps that failed."""
    try:
        errs = spec.problem.errors(arrays, spec.config, spec.traffic, params, t_final)
    except ValueError as e:
        notes.append(f"# reference: {e}")
        errs = {}
    relres_max = float(spec.config["krylov_relres_max"])
    values = dict(errs, max_relres=max(_relres(c) for c in counts),
                  failed_steps=_failed(counts, relres_max))
    limits = dict(spec.limits, max_relres=relres_max)
    return {name: {"value": values.get(name, math.inf), "limit": limit}
            for name, limit in limits.items()}


def run_cell(spec, seed, seconds, trace, device, t_start=T_START):
    """Run cell ``spec`` once on ``device``; returns (result dict, checks
    dict, notes for standard error)."""
    cfg, traffic = spec.config, spec.traffic
    params = spec.problem.parameters(seed, traffic)
    notes = [f"# cell {spec.name}: seed {seed}, {traffic['problem']} {params!r}, nx "
             f"{traffic['nx']}, degree {cfg['degree']}, {cfg['dtype']}, dt {traffic['dt']!r}"]
    cuda = device.type == "cuda"
    cell = C.set_up(cfg, traffic, spec.problem, params, device)
    setup_s = time.perf_counter() - t_start
    rec = SimpleNamespace(spans=dict(cell.spans), phases={}, phase_steps=0, counts=[],
                          trace=None, launches=[], trace_steps=0)
    if trace:
        prof, launches, counts_t, counts_p, times, phases = _traced_window(
            cell, seconds, TRACE_STEPS)
        counts = counts_t + counts_p
        rec.phases, rec.phase_steps, rec.launches = phases, len(counts_p), launches
        rec.trace_steps = len(counts_t)
        window_s = sum(times)
    else:
        window_s, counts, times = C.run_steps(cell, seconds)
    rec.counts = counts
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    spans = ", ".join(f"{k} {v!r}" for k, v in cell.spans.items())
    notes.append(f"# set-up {setup_s!r} s: {spans}")
    q = statistics.quantiles(times, n=4) if len(times) > 1 else [times[0]] * 3
    notes.append(f"# window: {len(counts)} steps in {window_s!r} s; step s min {min(times)!r}, "
                 f"q1 {q[0]!r}, median {q[1]!r}, q3 {q[2]!r}, max {max(times)!r}")
    notes.append(f"# counts, last step: {counts[-1]}; peak {peak} bytes")

    metrics, breakdown, dev = {}, None, {}
    if trace:
        rec.trace = _summarise(prof, notes) if cuda else None
        del prof
        if rec.trace is not None:
            t = rec.trace
            matched = sum(1 for i in range(len(rec.launches)) if i in t.launch_s)
            notes.append(f"# trace: {len(rec.launches)} port launches, {matched} with device "
                         f"time; busy {t.busy_s!r} of {t.window_s!r} s")
            dev = {"busy_s": t.busy_s, "window_s": t.window_s}
            breakdown = {"device_ops": t.device_ops, "idle_gaps": t.idle_gaps}
        for m in spec.per_layer:
            value = spec.readers[m["name"]].read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        e2e = {"step_s": window_s / len(counts), "setup_s": setup_s}
        for m in spec.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    notes.insert(0, _card_line(device))

    arrays = C.state_arrays(cell)
    t_final = cell.steps_done * cell.dt
    del cell
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = check_state(spec, params, counts, arrays, t_final, notes)
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())

    result = {
        "correct": correct,
        "attempted": len(counts),
        "failed": checks["failed_steps"]["value"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": spec.chips if cuda else 0,
            "memory_peak_bytes": int(peak),
            **dev,
        },
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, checks, notes


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    spec = manifest.cell_spec(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"# {args.workload} needs {spec.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    tf32 = bool(spec.config["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    result, checks, notes = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                                     torch.device("cuda:0"))
    found = jax_modules()
    if found:
        print(f"# refused: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for line in notes:
        print(line, file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

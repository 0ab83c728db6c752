"""The readers of the program's spans: solve_ms.tentative, solve_ms.pressure,
host_reads_per_step and host_wait_ms_per_step on a synthetic record of the
traced run's phase-timed steps."""

from types import SimpleNamespace

import pytest

from benchmark import manifest

NAMES = ("solve_ms.tentative", "solve_ms.pressure", "host_reads_per_step",
         "host_wait_ms_per_step")


def rec(phases, steps):
    return SimpleNamespace(phases=phases, phase_steps=steps, counts=[], spans={}, trace=None,
                           launches=[], trace_steps=0)


def test_readers_divide_by_the_phase_timed_steps():
    r = rec({"solve.tentative": [0.25, 0.5, 0.25], "solve.pressure": [0.125] * 4,
             "host.read": [0.001] * 10, "sweep": [1.0]}, 2)
    read = {n: manifest.load_reader(n).read(r) for n in NAMES}
    assert read["solve_ms.tentative"] == pytest.approx(500.0)
    assert read["solve_ms.pressure"] == pytest.approx(250.0)
    assert read["host_reads_per_step"] == 5.0
    assert read["host_wait_ms_per_step"] == pytest.approx(5.0)


@pytest.mark.parametrize("name", NAMES)
def test_readers_give_none_without_samples(name):
    reader = manifest.load_reader(name)
    assert reader.read(rec({}, 3)) is None
    assert reader.read(rec({"sweep": [1.0]}, 3)) is None  # a program without the spans
    assert reader.read(rec({"solve.tentative": [1.0], "solve.pressure": [1.0],
                            "host.read": [1.0]}, 0)) is None


def test_the_manifest_lists_them_in_both_cells():
    entries = {m["name"]: m for m in manifest.load_manifest()["per_layer"]}
    for name in NAMES:
        assert entries[name]["moves"] == "step_s"
        assert entries[name]["workloads"] == ["tg-k2-512", "tg-k4-256"]

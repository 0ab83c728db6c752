"""The reader of precond_replay_share on a synthetic record of the traced
run's phase-timed steps: the samples of the program's span
``krylov.replay`` over those of ``krylov.precond``."""

from types import SimpleNamespace

import pytest

from benchmark import manifest

NAME = "precond_replay_share"


def rec(phases, steps):
    return SimpleNamespace(phases=phases, phase_steps=steps, counts=[], spans={}, trace=None,
                           launches=[], trace_steps=0)


def test_share_of_the_replayed_applications():
    reader = manifest.load_reader(NAME)
    r = rec({"krylov.precond": [0.01] * 40, "krylov.replay": [0.001] * 39,
             "krylov.capture": [0.002], "sweep": [1.0]}, 2)
    assert reader.read(r) == pytest.approx(39 / 40)
    assert reader.read(rec({"krylov.precond": [0.01] * 4, "krylov.replay": [0.01] * 4},
                           1)) == 1.0


@pytest.mark.parametrize("phases, steps", [
    ({}, 3),
    ({"sweep": [1.0]}, 3),  # a program without the spans
    ({"krylov.precond": [0.01] * 5}, 1),  # one that replays no graph: the CPU, or the parent
    ({"krylov.replay": [0.01] * 5}, 1),
    ({"krylov.precond": [1.0], "krylov.replay": [1.0]}, 0),  # no phase-timed step
])
def test_no_reading_without_samples(phases, steps):
    assert manifest.load_reader(NAME).read(rec(phases, steps)) is None


def test_the_manifest_lists_it_in_both_cells():
    entry = {m["name"]: m for m in manifest.load_manifest()["per_layer"]}[NAME]
    assert entry["moves"] == "step_s" and entry["layer"] == "Krylov loops"
    assert entry["source"] == "program_span" and entry["unit"] == "share"
    assert entry["workloads"] == ["tg-k2-512", "tg-k4-256"]

"""The control on the card: the program with TF32 on, at a size a test can
hold, reads ``correct`` false on three seeds where the program as its
configuration states it (TF32 off) reads true.

The sound seed's state rounded to bfloat16 (the second control) reads
``correct`` false too.  The limits are this size's, set from readings on
an NVIDIA H100 80GB HBM3 (8 steps a seed;
``python3 -m benchmark.control ... --nx N --steps 8``):

- k = 2 at 128^2, dt = 1/256: TF32 off velocity 4.08e-7 .. 4.21e-7,
  pressure 6.69e-5 .. 6.90e-5; TF32 on velocity 5.88e-3 .. 5.90e-3,
  pressure 6.26e-3 .. 6.32e-3 (3 seeds each);
- k = 4 at 64^2, dt = 1/128: TF32 off velocity 4.79e-7 .. 4.97e-7,
  pressure 2.20e-5 .. 2.40e-5; TF32 on the tentative solves run to their
  cap and the velocity reads 30.8 .. 124.
"""

import pytest
import torch

from benchmark import control, manifest

CASES = {
    "tg-k2-512": dict(nx=128, dt=1 / 256, limits={"velocity_l2": 2e-5, "pressure_l2": 5e-4,
                                                  "trace_rms": 5e-4, "failed_steps": 0}),
    "tg-k4-256": dict(nx=64, dt=1 / 128, limits={"velocity_l2": 2e-5, "pressure_l2": 3e-4,
                                                 "trace_rms": 3e-4, "failed_steps": 0}),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the control runs on a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CASES))
def test_tf32_control_is_not_correct(cell, card):
    case = CASES[cell]
    spec = manifest.cell_spec(cell)
    spec.traffic = dict(spec.traffic, nx=case["nx"], dt=case["dt"])
    spec.limits = dict(case["limits"])
    sound, built = control.readings(spec, [31], float("inf"), card, False, steps=8)
    assert sound[0]["correct"] is True, sound
    rounded = sound[0]["bf16_state"]
    assert any(rounded[k] > v for k, v in case["limits"].items()), rounded
    tf32 = control.readings(spec, [34, 35, 36], float("inf"), card, True, built, steps=8)[0]
    assert all(r["correct"] is False for r in tf32), tf32
    assert torch.backends.cuda.matmul.allow_tf32 is False

"""A run with the timed path broken underneath reads ``correct`` false.

Each test drives ``run.run_cell`` (everything of a run but the look for a
card) on the CPU at 8^2, k = 2, with the stepper's ``step`` replaced by a
faulty one: a step that returns its state unchanged, a step that leaves
half of the cells (and facets) out, and a step whose answer is altered
where it is produced (one cell's velocity moved by 0.1), and a step whose
state is rounded to bfloat16 (the precision below the configuration's,
close to float32).  The limits are
this size's: the sound run reads velocity 5.5e-5, pressure 2.9e-4, trace
3.0e-4 after its window step (CPU, float32), held at about twice that.
"""

import pytest
import torch

from benchmark import manifest, run

LIMITS = {"velocity_l2": 1.2e-4, "pressure_l2": 6e-4, "trace_rms": 6e-4, "failed_steps": 0}


def tiny_spec():
    spec = manifest.cell_spec("tg-k2-512")
    spec.traffic = dict(spec.traffic, nx=8, dt=1 / 16)
    spec.limits = dict(LIMITS)
    return spec


def unchanged(step):
    def broken(self, Q, p, lam, tn, f):
        return Q, p, lam, step(self, Q, p, lam, tn, f)[3]
    return broken


def half_left_out(step):
    def broken(self, Q, p, lam, tn, f):
        Qn, pn, ln, counts = step(self, Q, p, lam, tn, f)
        Qn, pn, ln = list(Qn), list(pn), list(ln)
        for new, old in ((Qn, Q), (pn, p), (ln, lam)):
            half = new[0].shape[-1] // 2
            new[0] = torch.cat([new[0][..., :half], old[0][..., half:]], dim=-1)
        return Qn, pn, ln, counts
    return broken


def answer_altered(step):
    def broken(self, Q, p, lam, tn, f):
        Qn, pn, ln, counts = step(self, Q, p, lam, tn, f)
        Qn = list(Qn)
        Qn[0] = Qn[0].clone()
        Qn[0][..., 3] += 0.1
        return Qn, pn, ln, counts
    return broken


def rounded_to_bf16(step):
    def broken(self, Q, p, lam, tn, f):
        Qn, pn, ln, counts = step(self, Q, p, lam, tn, f)
        r = lambda s: [s[0].to(torch.bfloat16).to(s[0].dtype)] + list(s[1:])  # noqa: E731
        return r(Qn), r(pn), r(ln), counts
    return broken


def _run(spec, seed=2 ** 31 + 3):
    return run.run_cell(spec, seed, 0.0, 0, torch.device("cpu"))[0]


def test_sound_run_is_correct():
    assert _run(tiny_spec())["correct"] is True


@pytest.mark.parametrize("fault", [unchanged, half_left_out, answer_altered, rounded_to_bf16])
def test_fault_reads_not_correct(fault, monkeypatch):
    from incompressibleeulerhdg_tpu_torch.timesteppers.hdg_imex import (
        IncompressibleEulerHDGIMEXSSP2_332 as Stepper,
    )

    monkeypatch.setattr(Stepper, "step", fault(Stepper.step))
    result = _run(tiny_spec())
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())

"""The frozen byte and operation counts against the bound column of PERF.md's
kernel table (each row's shape and its bound in ms)."""

import pytest

from benchmark.roofline import bound_s, work

ROWS = [
    # kernel, dtype, shape keywords, bound ms, bound by
    ("fact_apply", "float32", dict(d1=10, m=131072, nseg=2), 0.0219, "bytes"),
    ("cross_pair", "float32", dict(d1=10, m=197120, nseg=4), 0.0659, "bytes"),
    ("cross_pair", "float32", dict(d1=10, m=65280, nseg=1), 0.0218, "bytes"),
    ("patch_solve", "float32", dict(d1=10, m=65280), 0.0842, "bytes"),
    ("gauss_jordan", "float32", dict(n=20, m=131072), 0.1252, "bytes"),
    ("gauss_jordan_select", "float32", dict(n=42, m=32768), 0.1380, "bytes"),
    ("fact_apply", "float32", dict(d1=10, m=524288, nseg=2), 0.0876, "bytes"),
    ("patch_solve", "float32", dict(d1=10, m=261632), 0.3374, "bytes"),
    ("gauss_jordan", "float32", dict(n=20, m=524288), 0.5008, "bytes"),
    ("cross_pair_cluster", "float32", dict(d1=21, m=16256, nseg=1), 0.0204, "bytes"),
    ("patch_solve_wide", "float32", dict(d1=21, m=16256), 0.0889, "bytes"),
    ("gauss_jordan_wide", "float32", dict(n=90, m=32768), 0.7131, "operations"),
    ("patch_solve_wide_bf16", "float32", dict(d1=21, m=16256, factors="bfloat16"), 0.0546,
     "bytes"),
]


@pytest.mark.parametrize("name,dtype,shape,ms,by", ROWS)
def test_bound_column(name, dtype, shape, ms, by):
    t, kind = bound_s(dtype, *work(name, dtype, **shape))
    assert kind == by
    assert round(t * 1e3, 4) == pytest.approx(ms, abs=1.5e-4)


def test_unknown_kernel_has_no_formula():
    with pytest.raises(KeyError):
        work("some_new_kernel", "float32", d1=10, m=1)

"""kernel_roofline.fact_apply_wide: K1w, the cell-field apply at a run-time
width: its share of its roofline over its recorded launches with device
time (``roofline_share.share``); None where it made none."""

from benchmark.metrics.roofline_share import share


def read(rec):
    return share(rec, "fact_apply_wide")

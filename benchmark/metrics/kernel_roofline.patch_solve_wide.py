"""kernel_roofline.patch_solve_wide: K3w, the patch solve at a run-time width
(a colour a launch): its share of its roofline over its recorded launches
with device time (``roofline_share.share``); None where it made none."""

from benchmark.metrics.roofline_share import share


def read(rec):
    return share(rec, "patch_solve_wide")

"""kernel_roofline.gauss_jordan_wide: K5w, the Gauss-Jordan inverse of the
tentative operator's blocks at a run-time n (at k = 7, n = 90, the
dispatch's register-tile plan): its share of its roofline over its
recorded launches with device time (``roofline_share.share``); None where
it made none."""

from benchmark.metrics.roofline_share import share


def read(rec):
    return share(rec, "gauss_jordan_wide")

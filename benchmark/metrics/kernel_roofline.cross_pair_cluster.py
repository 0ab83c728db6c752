"""kernel_roofline.cross_pair_cluster: K2c, the cross pair on thread-block
clusters (a colour or the full field a launch): its share of its roofline
over its recorded launches with device time (``roofline_share.share``);
None where it made none."""

from benchmark.metrics.roofline_share import share


def read(rec):
    return share(rec, "cross_pair_cluster")

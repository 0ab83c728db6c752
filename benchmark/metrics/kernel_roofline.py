"""kernel_roofline: the port's kernels' share of their roofline: the sum of
each recorded launch's bound (``benchmark/roofline.py``: bytes over HBM
bandwidth or operations over peak, the longer) over the sum of the device
time the profiler recorded for those launches.  Only launches with
recorded device time count; a launch whose kernel or shape the table does
not know leaves the metric out."""

from benchmark.roofline import bound_s, work


def read(rec):
    t = rec.trace
    if t is None or not t.launch_s:
        return None
    bound = spent = 0.0
    for i, seconds in t.launch_s.items():
        launch = rec.launches[i]
        try:
            nbytes, flops = work(launch["name"], launch["dtype"], d1=launch.get("d1"),
                                 m=launch["m"], nseg=launch.get("nseg", 1), n=launch.get("n"),
                                 factors=launch.get("factors"))
        except KeyError:
            return None
        bound += bound_s(launch["dtype"], nbytes, flops)[0]
        spent += seconds
    return 100.0 * bound / spent

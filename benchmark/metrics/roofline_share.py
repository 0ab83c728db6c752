"""One kernel's share of its roofline, the arithmetic of the readers
``kernel_roofline.<kernel>.py``: ``kernel_roofline.py``'s sum of bounds
(``benchmark/roofline.py``) over recorded device time, taken over the
launches of that kernel alone."""

from benchmark.roofline import bound_s, work

__all__ = ["share"]


def share(rec, kernel):
    """100 x the sum of the bounds of kernel ``kernel``'s recorded launches
    over the device time the profiler recorded for them; only launches with
    device time count.  None where the kernel made no such launch, or where
    one of its launches has a shape the table does not know."""
    t = rec.trace
    if t is None or not t.launch_s:
        return None
    bound = spent = 0.0
    for i, seconds in t.launch_s.items():
        launch = rec.launches[i]
        if launch.get("name") != kernel or not seconds > 0:
            continue
        try:
            nbytes, flops = work(kernel, launch["dtype"], d1=launch.get("d1"), m=launch["m"],
                                 nseg=launch.get("nseg", 1), n=launch.get("n"),
                                 factors=launch.get("factors"))
        except KeyError:
            return None
        bound += bound_s(launch["dtype"], nbytes, flops)[0]
        spent += seconds
    return 100.0 * bound / spent if spent > 0 else None

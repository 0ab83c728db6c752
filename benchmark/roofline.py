"""Operations, bytes and the roofline bound of one launch of a port kernel.

A frozen copy of the arithmetic of ``chip_smoke.py`` (``work``, ``bound``):
each input read once and each output written once, an FMA two
operations, against the published peaks of one NVIDIA H100 SXM (NVIDIA's
data sheet, dense rates): 3.35 TB/s of HBM, 67 TFLOP/s in float32 outside
the tensor cores and 67 TFLOP/s in float64 through them (DMMA).  The
bound of a launch is the longer of bytes over bandwidth and operations
over peak.  K3 and K3w on bfloat16 factors read Dinv0 and Sinv at two
bytes an entry.
"""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
ITEMSIZE = {"float32": 4, "float64": 8, "bfloat16": 2}

__all__ = ["HBM_BYTES_PER_S", "PEAK_FLOPS", "work", "bound_s"]


def work(name, dtype, d1=None, m=0, nseg=1, n=None, factors=None):
    """(bytes, floating-point operations) of one launch of kernel ``name``
    (its name in the port's kernel table) on ``m`` columns (facets, cells
    or blocks) of ``dtype``; ``nseg`` penalty blocks; ``n`` the block size
    of a Gauss–Jordan inverse; ``factors`` the patch factors' dtype.
    Raises KeyError for a kernel this table does not know."""
    size = ITEMSIZE[dtype]
    fsize = ITEMSIZE[factors or dtype]
    base = name.removesuffix("_bf16").removesuffix("_wide").removesuffix("_cluster")
    if base in ("gauss_jordan", "gauss_jordan_select", "gauss_jordan_blocked"):
        return size * 2 * n * n * m, 2 * n ** 3 * m  # A -> A^-1
    nu = 2 * d1
    if base == "fact_apply":  # A (d1, d1, m), P, x -> out
        return (size * (d1 * d1 * m + nseg * nu * nu + 2 * nu * m),
                2 * (2 * d1 * d1 + nu * nu) * m)
    if base == "cross_pair":  # K01, K10, Bp, Cp, x0, x1 -> y0, y1
        return (size * (2 * d1 * d1 * m + 2 * nseg * nu * nu + 4 * nu * m),
                4 * (2 * d1 * d1 + nu * nu) * m)
    if base == "patch_solve":  # Dinv0, Sinv, K01, K10, Bp, Cp, r0, r1 -> y0, y1
        return (fsize * 2 * nu * nu * m
                + size * (2 * d1 * d1 * m + 2 * nseg * nu * nu + 4 * nu * m),
                2 * (5 * nu * nu + 4 * d1 * d1) * m)
    raise KeyError(f"no work formula for kernel {name!r}")


def bound_s(dtype, nbytes, flops):
    """(seconds, "bytes" or "operations"): the least time of a launch."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

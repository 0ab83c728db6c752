"""A/B of the two Gauss-Jordan kernel entry points on a CUDA card.

Counterpart of tools/microbench_gj.py.  Times by device time
(``ab_cross_patch.device_time``: torch.profiler, the kernel's own duration;
the timer is named in the result), in turns:

- K4 (``csrc/gauss_jordan.cu``) against K5 (``csrc/gauss_jordan_select.cu``)
  at the tool's shape (20, 20, 2 nx^2); both are instantiations of one
  register-tiled template (``csrc/gauss_jordan.cuh``);
- K5 at n = 42 (the k = 4 blocks, beyond K4's n <= 32);
- the per-facet Schur product formulations of one colour (dense block
  products against the I2 (x) K split with one constant matrix product),
  plain PyTorch as in the JAX tool, where they are XLA (all their kernels).

Usage:  python -m incompressibleeulerhdg_tpu_torch.tools.microbench_gj [--nx 512]
"""

import argparse
import sys

import numpy as np
import torch

from .ab_cross_patch import device_time


def diag_dominant(n, m, dtype, seed, device="cuda"):
    """(n, n, m) blocks 0.1 N(0, 1) + 3 I, made from a numpy seed."""
    rng = np.random.default_rng(seed)
    A = 0.1 * rng.standard_normal((n, n, m)) + 3.0 * np.eye(n)[:, :, None]
    return torch.as_tensor(A, dtype=dtype, device=device)


def ab_gauss_jordan(nx, reps=20, dtype=torch.float32):
    """Device ms per launch of K4 and K5 at (20, 20, 2 nx^2), timed in turns
    K4, K5, K5, K4 (the better of each pair), and of K5 at (42, 42, 2 nx^2);
    ``timer`` names the timers used."""
    from ..linalg import smallinv

    m = 2 * nx * nx
    A20 = diag_dominant(20, m, dtype, 7)
    k4 = (lambda: smallinv.gauss_jordan_inv_bl(A20), "gauss_jordan_kernel")
    k5 = (lambda: smallinv.gauss_jordan_inv_select(A20), "gauss_jordan_select_kernel")
    t = [device_time(f, reps, match=sym) for f, sym in (k4, k5, k5, k4)]
    del A20
    A42 = diag_dominant(42, m, dtype, 8)
    t.append(device_time(lambda: smallinv.gauss_jordan_inv_select(A42), reps,
                         match="gauss_jordan_select_kernel"))
    ms = [v for v, _ in t]
    return {"k4_n20_ms": min(ms[0], ms[3]), "k5_n20_ms": min(ms[1], ms[2]), "k5_n42_ms": ms[4],
            "batch": m, "timer": "/".join(sorted({u for _, u in t}))}


def ab_schur_product(nx, reps=20, dtype=torch.float32):
    """Median ms of the two Schur-product formulations on one colour's
    shapes (n = 20, d1 = 10, m = nx^2)."""
    n, d1, m = 20, 10, nx * nx
    rng = np.random.default_rng(7)
    cast = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
    X = cast(rng.standard_normal((n, n, m)))
    K = cast(rng.standard_normal((d1, d1, m)))
    C = cast(rng.standard_normal((n, n)))

    def bmm(P, Q):
        return torch.einsum("ikf,kjf->ijf", P, Q)

    def dense_pair():
        Z = torch.zeros_like(K)
        E = torch.cat([torch.cat([K, Z], 1), torch.cat([Z, K], 1)], 0) + C[:, :, None]
        return bmm(E, bmm(X, E))

    def kron_split():
        def kron_apply(xx):
            top = torch.einsum("ijf,jkf->ikf", K, xx[:d1])
            bot = torch.einsum("ijf,jkf->ikf", K, xx[d1:])
            return torch.cat([top, bot], 0)

        def const_apply(xx):
            return (C @ xx.reshape(n, -1)).reshape(n, n, m)

        T = kron_apply(X) + const_apply(X)
        return kron_apply(T) + const_apply(T)

    return {"dense_pair_ms": device_time(dense_pair, reps)[0],
            "kron_split_ms": device_time(kron_split, reps)[0]}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nx", type=int, default=512)
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("microbench_gj: needs a CUDA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    gj = ab_gauss_jordan(args.nx, args.reps)
    m = gj["batch"]
    print(f"{torch.cuda.get_device_name(0)}: nx={args.nx} batch={m} float32, timer {gj['timer']}")
    nb = 2 * 20 * 20 * m * 4
    for key, label in (("k4_n20_ms", "GJ K4, n=20"), ("k5_n20_ms", "GJ K5, n=20")):
        print(f"{label:>40s} : {gj[key]:9.3f} ms  ({nb / gj[key] / 1e6:6.0f} GB/s eff)")
    print(f"{'GJ K5, n=42':>40s} : {gj['k5_n42_ms']:9.3f} ms")
    sp = ab_schur_product(args.nx, args.reps)
    print(f"{'Schur product: dense block pair':>40s} : {sp['dense_pair_ms']:9.3f} ms")
    print(f"{'Schur product: kron split + matmul':>40s} : {sp['kron_split_ms']:9.3f} ms")


if __name__ == "__main__":
    main()

"""Assembled tentative operator, its colored Schwarz preconditioner, and
kernels K1-K3.

Counterpart of incompressibleeulerhdg_tpu/linalg/preconditioners.py on its
flat branches (the ones the JAX CPU reference runs).  On a uniform
structured mesh (unit square or periodic square, preconditioners.py:562-592)
the tentative operator M - c f_impl of a stage is assembled batch-last with
the 2x2 component structure factored out:

    D  = I2 (x) Sown + Pcell[half]       Sown (d1, d1, nc), Pcell (2, nu, nu)
    Bx = I2 (x) Ks01 + Bp[color]         Ks01 (d1, d1, nf), Bp (ncol, nu, nu)
    Cx = I2 (x) Ks10 + Cp[color]

together with the patch factors of the multiplicative colored facet-pair
Schwarz sweep: the own-cell inverses Dinv (nu, nu, nc), their plus-cell
copies Dinv0 (nu, nu, nf) and the per-facet Schur inverses Sinv (nu, nu, nf).
On any other mesh (the unit disk, preconditioners.py:602-625) D, Bx and Cx
are dense (nu, nu, n) tables applied by ``einsum`` and reached by index
gathers; only the Gauss-Jordan inverses (K4) are kernels there.
``IEHDG_FACT=0`` (read at every build, as the JAX package's
``_fact_wanted``) gives a structured mesh the dense tables too, with its
patch factors built colour by colour on the rectangle layout and applied
by the same slices and rolls as the factored ones (K4, or K5 from k = 4,
are then its only kernels).  ``reuse_factors`` (the lagged preconditioner,
``IEHDG_LAG_PC``) builds fresh matvec tables and takes the patch factors
of an earlier build.  A
partition-local geometry (parallel/partition.py) takes the dense branch on
every mesh, with the ghost entries of each gathered source appended first:
each rank inverts its own cells' and its own facets' blocks.

The three kernels of the TPU package that apply these tables are hand-written
CUDA here, each beside its plain PyTorch version (the JAX fallback):

- K1 :func:`fact_apply`  (csrc/fact_apply.cu)  -- (I2 (x) A + P[segment]) x
- K2 :func:`cross_pair`  (csrc/cross_pair.cu)  -- both cross applies in one pass
- K3 :func:`patch_solve` (csrc/patch_solve.cu) -- one colour's patch solves

A CPU tensor goes to the plain version; a CUDA tensor launches a kernel,
chosen by the width d1 = (k + 2)(k + 3)/2 and the dtype
(:func:`width_kernels`): K1 is instantiated for the degrees k = 0 .. 6
(d1 in :data:`CUDA_D1`), K2 and K3 for k = 0 .. 3 (:data:`CROSS_D1`,
:data:`PATCH_D1`).  The cross pair at k = 4 .. 7 (d1 = 21 .. 45)
launches K2c (csrc/cross_pair_cluster.cu: persistent thread-block
clusters, each rank streaming its rows of the tables, planned by
:func:`cross_pair_plan`), as :data:`CROSS_PAIR_MEASURED` records from a
one-process A/B of K2, K2w and K2c, and so does k = 8 .. 11 (d1 = 55 ..
91, K2c against K2w) and k = 12 in float32; any other width launches the
runtime-width counterparts K1w, K2w (csrc/wide_apply.cu) and K3w
(csrc/patch_solve_wide.cu, from d1 = 21: a thread-block cluster a facet
tile up to d1 = 80, one thread block a tile past it (measured faster at
d1 = 91 .. 120 than clusters of up to 16 on 32-byte table rows, which
would hold Dinv0 on chip there), planned by :func:`patch_wide_plan`).
K2, K3 and K3w read their per-facet tables with TMA and K2c with
16-byte loads, which need 16-byte rows: the operator's facet tables are
allocated with a padded column stride (:func:`pad_table`; the
plain versions and K1w, K2w read the same views).

``pc_dtype`` (``IEHDG_PC_BF16=1`` on the float32 projection path, read by
timesteppers/hdg_imex.py) stores the patch factors ``Dinv0`` and ``Sinv``
in bfloat16, inverted in the working dtype and then cast, as the JAX
package's ``store`` does (preconditioners.py:481); every other table stays
in the working dtype.  The plain versions upcast a factor slice at use
(exact, as jnp's bfloat16 x float32 promotion), and K3 and K3w launch
their bfloat16-factor variants (``patch_solve_bf16``,
``patch_solve_wide_bf16``: the factors read as bfloat16, summed in
float32).
"""

import os
from dataclasses import dataclass

import torch

from .. import kernels
from ..ops import structured as st
from ..ops.fields import (cells_ext, gather_facet_contribs, gather_sides, interior_mask,
                          slot_values, table_ext)
from ..utils.logging import span
from .smallinv import gauss_jordan_inv_bl

__all__ = [
    "TentativeOperator",
    "build_tentative_operator",
    "dense_blocks",
    "tentative_operator_matvec",
    "fact_apply",
    "fact_apply_plain",
    "cross_pair",
    "cross_pair_plain",
    "patch_solve",
    "patch_solve_plain",
    "pad_table",
    "tile_facets",
    "width_kernels",
    "cross_pair_plan",
    "tentative_patch_apply",
    "tentative_colored_apply",
]


def _fact_wanted():
    """Whether a uniform structured mesh stores factored tentative tables:
    ``IEHDG_FACT=1/0`` overrides, on by default (preconditioners.py:28-45)."""
    flag = os.environ.get("IEHDG_FACT")
    return True if flag is None else flag == "1"


@dataclass
class TentativeOperator:
    """Per-stage tentative operator and its Schwarz factors: factored tables
    (``Sown`` ... ``Cp``) on uniform structured meshes, dense tables
    (``D``, ``Bx``, ``Cx``) elsewhere; the other group is None.
    ``graphs`` (no field) holds the CUDA graphs of the tentative solve's
    preconditioner on these tables (``krylov.graphed``), which live as long
    as the operator."""

    Dinv: torch.Tensor  # (nu, nu, nc) own-cell inverses
    Sinv: torch.Tensor  # (nu, nu, nf) patch Schur inverses (identity on boundary)
    Dinv0: torch.Tensor  # (nu, nu, nf) Dinv of each facet's plus cell
    Sown: torch.Tensor = None  # (d1, d1, nc) scalar own-cell blocks
    Pcell: torch.Tensor = None  # (2, nu, nu) per-half constant penalty blocks
    Ks01: torch.Tensor = None  # (d1, d1, nf) scalar cross blocks, plus rows
    Ks10: torch.Tensor = None  # (d1, d1, nf) scalar cross blocks, minus rows
    Bp: torch.Tensor = None  # (ncol, nu, nu) per-colour constant cross penalty
    Cp: torch.Tensor = None  # (ncol, nu, nu)
    D: torch.Tensor = None  # (nu, nu, nc) dense own-cell blocks
    Bx: torch.Tensor = None  # (nu, nu, nf) dense cross blocks: plus rows, minus columns
    Cx: torch.Tensor = None  # (nu, nu, nf) minus rows, plus columns

    def __post_init__(self):
        self.graphs = {}


CUDA_D1 = (3, 6, 10, 15, 21, 28, 36)  # k = 0 .. 6: K1's instantiations
CROSS_D1 = (3, 6, 10, 15)  # k = 0 .. 3: K2's
PATCH_D1 = (3, 6, 10, 15)  # k = 0 .. 3: K3's; K3w takes every other width
SMEM_MAX = 232448  # bytes of shared memory a thread block may use (H100)
PATCH_WIDE_ROW_BYTES = (64, 128)  # K3w: bytes of a table row a cluster reads
PATCH_WIDE_CLUSTER_MAX = 8  # the portable cluster size
# the widest d1 of a K3w cluster plan: where float32 and float64 plans end;
# bfloat16 factors would fit clusters past it, not measured against the
# plan without a cluster there
PATCH_WIDE_CLUSTER_D1_MAX = 80
PATCH_WIDE_THREADS_MAX = 512  # csrc/patch_solve_wide.cu K3W_THREADS_MAX
PATCH_WIDE_DEV_FACETS = (32, 16, 8)  # K3w past every cluster plan: facets a thread block
PATCH_WIDE_DEV_THREADS = 256  # csrc/patch_solve_wide.cu PATCH_WIDE_DEV_THREADS
# K3w's fastest (F, CS) by device time on one 128^2 colour, from
# tools/ab_patch.py --sweep (NVIDIA H100 80GB HBM3, 700.00 W, PERF.md
# section 6), keyed by the patch factors' dtype (bfloat16: float32 vectors,
# --sweep --bf16; CS = 0 the plan without a cluster); other widths take
# the rule in patch_wide_plan
PATCH_WIDE_MEASURED = {
    (21, torch.float32): (32, 3), (21, torch.float64): (16, 3),
    (28, torch.float32): (32, 4), (36, torch.float32): (16, 4),
    (45, torch.float32): (16, 5), (55, torch.float32): (32, 8),
    (28, torch.float64): (16, 4), (36, torch.float64): (16, 4),
    (45, torch.float64): (16, 5), (55, torch.float64): (16, 8),
    (21, torch.bfloat16): (32, 7), (28, torch.bfloat16): (32, 7),
    (36, torch.bfloat16): (32, 8), (45, torch.bfloat16): (32, 6),
    (55, torch.bfloat16): (16, 5), (66, torch.bfloat16): (16, 6),
    (78, torch.bfloat16): (32, 0),
}
CROSS_CLUSTER_ROW_BYTES = (64, 128, 256)  # K2c: bytes of a table row a tile reads
CROSS_CLUSTER_MAX = 8  # csrc/cross_pair_cluster.cu CROSS_CLUSTER_MAX
CROSS_CLUSTER_THREADS_MAX = 512  # csrc/cross_pair_cluster.cu CROSS_CLUSTER_THREADS_MAX
# K2c's fastest (F, CS) by device time on one 128^2 colour, from
# tools/ab_cross.py --sweep (NVIDIA H100 80GB HBM3, 700.00 W, PERF.md
# section 6); other widths take the rule in cross_pair_plan
CROSS_CLUSTER_MEASURED = {
    (21, torch.float32): (64, 2), (28, torch.float32): (64, 2),
    (36, torch.float32): (64, 5), (45, torch.float32): (64, 3),
    (21, torch.float64): (32, 3), (28, torch.float64): (32, 2),
    (36, torch.float64): (32, 3), (45, torch.float64): (32, 3),
    (55, torch.float32): (64, 4), (66, torch.float32): (64, 5),
    (78, torch.float32): (64, 5), (91, torch.float32): (32, 3),
    (55, torch.float64): (32, 4), (66, torch.float64): (32, 5),
    (78, torch.float64): (16, 4), (91, torch.float64): (16, 4),
}
# the cross pair's kernel at a width and dtype where tools/ab_cross.py
# measured K2, K2w and K2c in one process on the 128^2 mesh (the fastest
# on one colour, the kind most launches are; NVIDIA H100 80GB HBM3,
# 700.00 W, PERF.md section 6); other widths take K2 where it is
# instantiated (CROSS_D1), else K2w
CROSS_PAIR_MEASURED = {(d1, dtype): "cross_pair_cluster" for d1 in (21, 28, 36, 45, 55, 66, 78, 91)
                       for dtype in (torch.float32, torch.float64)}
# k = 12 in float32 (tools/ab_cross.py --widths 105,120); K2w keeps float64
# there and d1 = 120, where the two tied within 1% in float32
CROSS_PAIR_MEASURED[105, torch.float32] = "cross_pair_cluster"


def width_kernels(d1, dtype=torch.float32, factors=None):
    """Names of the kernels that K1, K2, K3's wrappers launch at width d1
    and ``dtype``: ``fact_apply`` at its instantiated widths
    (:data:`CUDA_D1`), else ``fact_apply_wide``; the cross pair's kernel
    of :data:`CROSS_PAIR_MEASURED`, else ``cross_pair`` at its own widths
    (:data:`CROSS_D1`), else ``cross_pair_wide``; ``patch_solve`` at its
    own (:data:`PATCH_D1`), else ``patch_solve_wide``, each with the suffix
    ``_bf16`` where the patch factors' dtype ``factors`` is bfloat16."""
    cross = CROSS_PAIR_MEASURED.get((d1, dtype)) or \
        ("cross_pair" if d1 in CROSS_D1 else "cross_pair_wide")
    patch = "patch_solve" if d1 in PATCH_D1 else "patch_solve_wide"
    if factors == torch.bfloat16:
        patch += "_bf16"
    return ("fact_apply" if d1 in CUDA_D1 else "fact_apply_wide", cross, patch)


def _wide_tables(*tables):
    """Tables of one shape class with a common batch-last column stride ``ld``
    (strides (b * ld, ld, 1), ``ld`` >= the column count, as :func:`pad_table`
    or ``contiguous`` leave them), as K1w and K2w read them: the tables
    themselves where they have one, else contiguous copies.  Returns
    (tables, ld)."""
    ld = tables[0].stride(1)
    if all(t.stride() == (t.shape[1] * ld, ld, 1) and ld >= t.shape[2] for t in tables):
        return tables, ld
    tables = [t.contiguous() for t in tables]
    return tables, tables[0].shape[2]


def patch_wide_smem(d1, F, CS, size, tsize=None):
    """Shared bytes of a K3w thread block (csrc/patch_solve_wide.cu
    ``patch_wide_layout``): the rank's RS = ceil(d1 / CS) scalar rows of
    Dinv0 (2 RS slots of nu table rows x F facets, of ``tsize`` bytes an
    entry, default ``size``), two vectors (nu x F, ``size`` bytes an
    entry), each 128-byte aligned, and an mbarrier a slot."""
    tsize = tsize or size
    nu, rs = 2 * d1, -(-d1 // CS)
    region = lambda s: -(-nu * F * s // 128) * 128
    return 2 * rs * region(tsize) + 2 * region(size) + 2 * rs * 8


def patch_wide_plan(d1, dtype, F=None, CS=None, factors=None):
    """K3w's launch plan at width d1, vectors of ``dtype`` and patch factors
    of ``factors`` (default ``dtype``; bfloat16 with float32 halves the
    staged rows of Dinv0).  A cluster plan (``path`` "cluster"):
    F facets (table columns) a cluster of CS thread blocks, rank r owning
    the scalar rows r d1 / CS .. (r + 1) d1 / CS - 1 (both components),
    ``RS`` = ceil(d1 / CS) the most a rank holds, ``threads`` = 2 RS F (one
    row of one facet each) and ``smem_bytes`` (:func:`patch_wide_smem`).
    F x the element size is one of :data:`PATCH_WIDE_ROW_BYTES`; a cluster
    plan needs nu <= 256 (the rows of a TMA box),
    :data:`PATCH_WIDE_THREADS_MAX` threads and 232,448 shared bytes at
    most, and d1 <= :data:`PATCH_WIDE_CLUSTER_D1_MAX`.  The default is the
    measured fastest (:data:`PATCH_WIDE_MEASURED`, keyed by the factors'
    dtype) where there is one, else the most facets x rows a thread block
    (F RS) within half the shared memory, then the widest table rows (over
    the whole where nothing fits half).  Where no cluster plan fits (from
    d1 = 81, float32 and float64 alike: k = 11 on) the plan is ``path``
    "device", ``CS`` = 0, ``RS`` = d1: F of :data:`PATCH_WIDE_DEV_FACETS`
    facets a thread block of :data:`PATCH_WIDE_DEV_THREADS` threads, the
    widest whose three vectors (3 nu F elements) fit its shared memory,
    each row's terms streamed in load groups, Dinv0 read from device
    memory in phases 1 and 5.  ``F`` and ``CS`` (0
    for the device plan) fix a plan.  Raises NotImplementedError past every
    plan (float64 from d1 = 606, float32 from 1,211)."""
    factors = factors or dtype
    if F is None and CS is None and (d1, factors) in PATCH_WIDE_MEASURED:
        F, CS = PATCH_WIDE_MEASURED[d1, factors]
        return patch_wide_plan(d1, dtype, F, CS, factors)
    size = torch.empty((), dtype=dtype).element_size()
    tsize = torch.empty((), dtype=factors).element_size()
    nu = 2 * d1
    plans = []
    clusters = () if CS == 0 or d1 > PATCH_WIDE_CLUSTER_D1_MAX else \
        (CS,) if CS else range(1, PATCH_WIDE_CLUSTER_MAX + 1)
    for f in (F,) if F else (b // size for b in PATCH_WIDE_ROW_BYTES):
        for cs in clusters:
            rs = -(-d1 // cs)
            smem = patch_wide_smem(d1, f, cs, size, tsize)
            if f * size not in PATCH_WIDE_ROW_BYTES or cs > min(d1, PATCH_WIDE_CLUSTER_MAX) or \
                    nu > 256 or 2 * rs * f > PATCH_WIDE_THREADS_MAX or smem > SMEM_MAX:
                continue
            plans.append({"path": "cluster", "F": f, "CS": cs, "RS": rs, "threads": 2 * rs * f,
                          "smem_bytes": smem})
    if plans:
        return min(plans, key=lambda p: (
            p["smem_bytes"] > SMEM_MAX // 2, -p["F"] * p["RS"], -p["F"], p["CS"]))
    if CS == 0 or (CS is None and F is None):
        for f in (F,) if F else PATCH_WIDE_DEV_FACETS:
            smem = 3 * nu * f * size
            if f in PATCH_WIDE_DEV_FACETS and smem <= SMEM_MAX:
                return {"path": "device", "F": f, "CS": 0, "RS": d1,
                        "threads": PATCH_WIDE_DEV_THREADS, "smem_bytes": smem}
    raise NotImplementedError(
        f"patch_solve_wide: no plan at d1 = {d1} ({dtype}, F = {F}, CS = {CS}): no cluster of "
        f"at most {PATCH_WIDE_CLUSTER_MAX} thread blocks stages its rows of Dinv0, and the "
        f"three facet vectors of {min(PATCH_WIDE_DEV_FACETS)} facets exceed the {SMEM_MAX} B "
        f"a thread block may use")


def cross_pair_smem(d1, F, CS, size):
    """Shared bytes of a K2c thread block (csrc/cross_pair_cluster.cu
    ``cross_cluster_layout``): two buffers of both inputs (NP rows x F
    facets each, NP = nu rounded up to 16 bytes) and the rank's 2 RS rows
    of both penalty blocks (NP each), RS = ceil(d1 / CS)."""
    vec = 16 // size
    np_, rs = -(-2 * d1 // vec) * vec, -(-d1 // CS)
    return (4 * np_ * F + 4 * rs * np_) * size


def cross_pair_plan(d1, dtype, F=None, CS=None):
    """K2c's launch plan at width d1: F facets (table columns) a tile of a
    cluster of CS thread blocks, rank r owning the scalar rows r d1 / CS ..
    (r + 1) d1 / CS - 1 of both sides and components, ``RS`` = ceil(d1 /
    CS) the most a rank holds, ``threads`` = 2 RS F / VEC (one row of one
    side for VEC = 16 bytes of facets each) and ``smem_bytes``
    (:func:`cross_pair_smem`).  F x the element size is one of
    :data:`CROSS_CLUSTER_ROW_BYTES`; a plan needs
    :data:`CROSS_CLUSTER_THREADS_MAX` threads and 232,448 shared bytes at
    most, and CS <= min(d1, :data:`CROSS_CLUSTER_MAX`).  The default is the
    measured fastest (:data:`CROSS_CLUSTER_MEASURED`) where there is one,
    else the 256-byte rows (every measured width's choice) on the fewest
    ranks, then the other rows, widest first.  ``F`` and ``CS`` fix a plan.  Raises
    NotImplementedError where no plan fits."""
    size = torch.empty((), dtype=dtype).element_size()
    vec = 16 // size
    plans = []
    clusters = (CS,) if CS else range(1, CROSS_CLUSTER_MAX + 1)
    for f in (F,) if F else (b // size for b in CROSS_CLUSTER_ROW_BYTES):
        for cs in clusters:
            rs = -(-d1 // cs)
            threads, smem = 2 * rs * (f // vec), cross_pair_smem(d1, f, cs, size)
            if f * size not in CROSS_CLUSTER_ROW_BYTES or not 1 <= cs <= min(d1, CROSS_CLUSTER_MAX) \
                    or threads > CROSS_CLUSTER_THREADS_MAX or smem > SMEM_MAX:
                continue
            plans.append({"F": f, "CS": cs, "RS": rs, "threads": threads, "smem_bytes": smem})
    if not plans:
        raise NotImplementedError(
            f"cross_pair_cluster: no plan at d1 = {d1} ({dtype}, F = {F}, CS = {CS}) within "
            f"{CROSS_CLUSTER_THREADS_MAX} threads and {SMEM_MAX} shared bytes a thread block")
    best = [p for p in plans if (p["F"], p["CS"]) == CROSS_CLUSTER_MEASURED.get((d1, dtype))]
    return best[0] if best else min(plans, key=lambda p: (-p["F"], p["CS"]))


def pad_table(A):
    """A batch-last table (a, b, n) as a view of an (a, b, ld) buffer whose
    rows are 16 bytes aligned (``ld`` = n rounded up to 16 bytes): the layout
    the TMA kernels K2 and K3 read.  Returns ``A`` itself when it already has
    that layout."""
    a, b, n = A.shape
    ld = kernels.padded_ld(n, A.dtype)
    if A.stride() == (b * ld, ld, 1) and A.data_ptr() % kernels.TMA_ALIGN == 0:
        return A
    buf = A.new_empty((a, b, ld))
    buf[:, :, :n] = A
    buf[:, :, n:] = 0
    return buf[:, :, :n]


def _cat_table(parts):
    """torch.cat of batch-last tables along the columns, into a padded table."""
    a, b = parts[0].shape[:2]
    n = sum(p.shape[2] for p in parts)
    buf = parts[0].new_zeros((a, b, kernels.padded_ld(n, parts[0].dtype)))
    c = 0
    for p in parts:
        buf[:, :, c : c + p.shape[2]] = p
        c += p.shape[2]
    return buf[:, :, :n]


def tile_facets(kernel, d1, dtype):
    """Facets per block tile of K2 ("cross_pair") or K3 ("patch_solve"): the
    TC of CrossTile / PatchTile in csrc/cross_pair.cu, csrc/patch_solve.cu
    (128-byte table rows for K2, 64 above d1 = 15; 64-byte rows for K3 up to
    d1 = 10, 32 at d1 = 15, 16 from d1 = 21 on)."""
    size = torch.empty((), dtype=dtype).element_size()
    if kernel == "cross_pair":
        return (64 if d1 > 15 else 128) // size
    if kernel == "patch_solve":
        return (64 // size) // (4 if d1 > 15 else 2 if d1 > 10 else 1)
    raise ValueError(kernel)


def _bm(A, x):
    """Batch-last block matvec: (n, n, m) x (n, m) -> (n, m).  A bfloat16
    table (a patch factor) is upcast to x's dtype first: exact, as jnp's
    bfloat16 x float32 promotion."""
    return torch.einsum("ijn,jn->in", A.to(x.dtype), x)


def _bmm(A, B):
    """Batch-last block product: (n, n, m) x (n, n, m) -> (n, n, m)."""
    return torch.einsum("ikf,kjf->ijf", A, B)


def _bm2(A, x):
    """Scalar block applied to both components: (d1, d1, m) x (nu, m)."""
    d1 = A.shape[0]
    return torch.einsum("ijn,ajn->ain", A, x.reshape(2, d1, -1)).reshape(x.shape)


def _kron2(A):
    """I2 (x) A: (d1, d1, m) -> (nu, nu, m)."""
    d1, _, m = A.shape
    out = A.new_zeros((2, d1, 2, d1, m))
    out[0, :, 0] = A
    out[1, :, 1] = A
    return out.reshape(2 * d1, 2 * d1, m)


# ----------------------------------------------------------------------
# K1: factored block apply
# ----------------------------------------------------------------------


def fact_apply_plain(A, P, bounds, x, aoff=0):
    """Plain version of K1 (the JAX fallback ``_bm2(A, x) + P @ x``):
    out[:, c] = (I2 (x) A[:, :, aoff + c] + P[s]) x[:, c] with s the segment
    ``bounds[s] <= c < bounds[s + 1]``; zero penalty past ``bounds[-1]``."""
    m = x.shape[1]
    z = _bm2(A[:, :, aoff : aoff + m], x)
    parts = [P[k] @ x[:, bounds[k] : bounds[k + 1]] for k in range(len(bounds) - 1)]
    if m > bounds[-1]:
        parts.append(x.new_zeros((x.shape[0], m - bounds[-1])))
    return z + torch.cat(parts, dim=1)


@kernels.graph_cut(("x",), 1)
def fact_apply(A, P, bounds, x, aoff=0):
    """K1: (I2 (x) A[:, :, aoff + c] + P[segment of c]) x[:, c] for every
    column c of x (nu, m); A (d1, d1, M), P (nseg, nu, nu), ``bounds`` the
    nseg + 1 segment offsets into x's columns."""
    if x.device.type == "cpu":
        return fact_apply_plain(A, P, bounds, x, aoff)
    P, x = P.contiguous(), x.contiguous()
    d1 = A.shape[0]
    nu, m = x.shape
    if A.shape[1] != d1 or nu != 2 * d1 or P.shape[1:] != (nu, nu) or \
            P.shape[0] != len(bounds) - 1 or aoff + m > A.shape[2]:
        raise ValueError(f"fact_apply: shapes A {tuple(A.shape)} P {tuple(P.shape)} x {tuple(x.shape)}")
    name = width_kernels(d1, x.dtype)[0]
    if name == "fact_apply":
        A = A.contiguous()
        lda = A.shape[2]
    else:
        (A,), lda = _wide_tables(A)
    dev, code = kernels.check_cuda(name, P, x, tables=(A,))
    out, = kernels.launch_outputs(x, 1)
    if m == 0:
        return out
    seg, nseg = kernels.seg_array(bounds)
    kernels.launch(name, dev, code, d1, A.data_ptr(), lda, aoff,
                   P.data_ptr(), seg, nseg, x.data_ptr(), out.data_ptr(), m,
                   kernels.stream_ptr(x))
    return out


# ----------------------------------------------------------------------
# K2: fused cross pair
# ----------------------------------------------------------------------


def cross_pair_plain(K01, K10, Bp, Cp, bounds, x0, x1, aoff=0):
    """Plain version of K2 (the JAX fallback: two factored applies)."""
    return (fact_apply_plain(K01, Bp, bounds, x1, aoff),
            fact_apply_plain(K10, Cp, bounds, x0, aoff))


@kernels.graph_cut(("x0", "x1"), 2)
def cross_pair(K01, K10, Bp, Cp, bounds, x0, x1, aoff=0):
    """K2: y0 = (I2 (x) K01 + Bp[s]) x1 and y1 = (I2 (x) K10 + Cp[s]) x0 in
    one pass over columns c of x0/x1 (nu, m) (tables at column aoff + c)."""
    if x0.device.type == "cpu":
        return cross_pair_plain(K01, K10, Bp, Cp, bounds, x0, x1, aoff)
    Bp, Cp = Bp.contiguous(), Cp.contiguous()
    x0, x1 = x0.contiguous(), x1.contiguous()
    d1 = K01.shape[0]
    nu, m = x0.shape
    if K10.shape != K01.shape or x1.shape != x0.shape or nu != 2 * d1 or \
            Bp.shape != Cp.shape or Bp.shape[1:] != (nu, nu) or \
            Bp.shape[0] != len(bounds) - 1 or aoff + m > K01.shape[2]:
        raise ValueError(f"cross_pair: shapes K {tuple(K01.shape)} P {tuple(Bp.shape)} x {tuple(x0.shape)}")
    name = width_kernels(d1, x0.dtype)[1]
    if name == "cross_pair_wide":
        (K01, K10), ld = _wide_tables(K01, K10)
    dev, code = kernels.check_cuda(name, Bp, Cp, x0, x1, tables=(K01, K10))
    if name != "cross_pair_wide":  # TMA tiles (K2) or 16-byte table loads (K2c)
        ld = kernels.table_ld(name, K01, K10)
    plan = ()
    if name == "cross_pair_cluster":
        p = cross_pair_plan(d1, x0.dtype)
        plan = (p["F"], p["CS"], p["threads"], p["smem_bytes"])
    y0, y1 = kernels.launch_outputs(x0, 2)
    if m == 0:
        return y0, y1
    seg, nseg = kernels.seg_array(bounds)
    kernels.launch(name, dev, code, d1, *plan, K01.data_ptr(), K10.data_ptr(),
                   ld, aoff, Bp.data_ptr(), Cp.data_ptr(), seg, nseg,
                   x0.data_ptr(), x1.data_ptr(), y0.data_ptr(), y1.data_ptr(), m,
                   kernels.stream_ptr(x0))
    return y0, y1


# ----------------------------------------------------------------------
# K3: fused colour patch solve
# ----------------------------------------------------------------------


def patch_solve_plain(Dinv0, Sinv, K01, K10, Bp_k, Cp_k, r0, r1, off):
    """Plain version of K3 (the JAX factored-branch composition,
    preconditioners.py:1374-1379); bfloat16 factors are upcast slice by
    slice (:func:`_bm`)."""
    m = r0.shape[1]
    seg = (0, m)
    Di = Dinv0[:, :, off : off + m]
    w = _bm(Di, r0)
    t = r1 - fact_apply_plain(K10, Cp_k[None], seg, w, off)
    y1 = _bm(Sinv[:, :, off : off + m], t)
    y0 = _bm(Di, r0 - fact_apply_plain(K01, Bp_k[None], seg, y1, off))
    return y0, y1


@kernels.graph_cut(("r0", "r1"), 2)
def patch_solve(Dinv0, Sinv, K01, K10, Bp_k, Cp_k, r0, r1, off):
    """K3: the exact 2x2 block-Schur patch solves of the facets at table
    columns off .. off + m - 1 for residual sides r0/r1 (nu, m):

        w = Dinv0 r0;  t = r1 - (I2 (x) K10 + Cp) w;  y1 = Sinv t;
        y0 = Dinv0 (r0 - (I2 (x) K01 + Bp) y1)

    On the card the four tables must have :func:`pad_table`'s layout (K3
    and K3w read them with TMA).  Factors (``Dinv0``, ``Sinv``) in
    bfloat16 with float32 vectors launch the ``_bf16`` variant (their own
    column stride); any other mix of dtypes raises TypeError.
    """
    if r0.device.type == "cpu":
        return patch_solve_plain(Dinv0, Sinv, K01, K10, Bp_k, Cp_k, r0, r1, off)
    ts = [t.contiguous() for t in (Bp_k, Cp_k, r0, r1)]
    Bp_k, Cp_k, r0, r1 = ts
    d1 = K01.shape[0]
    nu, m = r0.shape
    nf = Dinv0.shape[2]
    if nu != 2 * d1 or Dinv0.shape != (nu, nu, nf) or Sinv.shape != Dinv0.shape or \
            K01.shape != (d1, d1, nf) or K10.shape != K01.shape or \
            Bp_k.shape != (nu, nu) or Cp_k.shape != (nu, nu) or \
            r1.shape != r0.shape or off + m > nf:
        raise ValueError(f"patch_solve: shapes Dinv0 {tuple(Dinv0.shape)} K {tuple(K01.shape)} r {tuple(r0.shape)}")
    name = width_kernels(d1, r0.dtype, Dinv0.dtype)[2]
    dev, code = kernels.check_cuda(name, *ts, tables=(K01, K10), factors=(Dinv0, Sinv))
    if code == 2:  # bfloat16 factors: a column stride of their own
        ld = (kernels.table_ld(name, Dinv0, Sinv), kernels.table_ld(name, K01, K10))
    else:
        ld = (kernels.table_ld(name, Dinv0, Sinv, K01, K10),)
    plan = ()
    if name.startswith("patch_solve_wide"):
        p = patch_wide_plan(d1, r0.dtype, factors=Dinv0.dtype)
        plan = (p["F"], p["CS"], p["threads"], p["smem_bytes"])
    y0, y1 = kernels.launch_outputs(r0, 2)
    if m == 0:
        return y0, y1
    kernels.launch(name, dev, code, d1, *plan, Dinv0.data_ptr(), Sinv.data_ptr(),
                   K01.data_ptr(), K10.data_ptr(), *ld, off, Bp_k.data_ptr(),
                   Cp_k.data_ptr(), r0.data_ptr(), r1.data_ptr(), y0.data_ptr(),
                   y1.data_ptr(), m, kernels.stream_ptr(r0))
    return y0, y1


# ----------------------------------------------------------------------
# per-stage build
# ----------------------------------------------------------------------


def build_tentative_operator(geom, star, c, alpha=1.0, upwind=True, pc_dtype=None,
                             reuse_factors=None):
    """Assemble the blocks and the Schwarz factors of one stage.

    The 2x2 cell patch [[D_plus, Bx], [Cx, D_minus]] of every interior facet
    is factorised in block-Schur form: own-cell inverses (K4) plus the
    per-facet Schur inverse of S = D_minus - Cx Dinv_plus Bx (K4).  A
    uniform structured mesh (square or periodic) gets the factored tables
    that K1-K3 apply, unless ``IEHDG_FACT=0``; any other mesh (the unit
    disk) gets dense (nu, nu, n) tables, the JAX package's branch at
    preconditioners.py:352-357, 429-448 and 602-625.  ``c`` = a_ii * dt is
    a float.

    ``pc_dtype``: the dtype the patch factors ``Dinv0`` and ``Sinv`` are
    stored in (``IEHDG_PC_BF16=1``: bfloat16), default the working dtype;
    they are inverted in the working dtype and then cast.  The own-cell
    ``Dinv`` and the matvec tables keep the working dtype.

    ``reuse_factors``: an earlier operator whose patch factors (``Dinv``,
    ``Dinv0``, ``Sinv``) this one takes instead of inverting its own (the
    lagged preconditioner, preconditioners.py:450-475); the matvec tables
    are built fresh, so only the preconditioner lags.

    The block inversions (``Dinv`` and each colour's ``Sinv``) and the
    Schur blocks between them run inside the span ``tentative_inverse``
    (``utils/logging.py``), synchronised at both ends when timed.
    """
    factored = geom.shift is not None and _fact_wanted()
    if factored and geom.uniform is None:
        raise NotImplementedError("a structured mesh without uniform facet families")
    star_bl, snq = star
    d1 = geom.d1
    dtype, dev = star_bl.dtype, star_bl.device
    c = float(c)
    upw = 1.0 if upwind else 0.0

    # own-cell scalar blocks: mass + c * volume convection + facet terms
    star_q = torch.einsum("qi,aic->aqc", geom.phi1, star_bl)
    jinv = geom.jac_inv
    R = torch.stack([jinv[b, 0] * star_q[0] + jinv[b, 1] * star_q[1] for b in (0, 1)])
    Gvol = torch.einsum("q,qi,qjb->ijbq", geom.wq, geom.phi1, geom.gphi1)
    S_own = c * geom.det_jac * torch.einsum("ijbq,bqc->ijc", Gvol, R)
    S_own = S_own + geom.det_jac * geom.m1[:, :, None]

    Gt = torch.einsum("tqi,tqj->tijq", geom.tphi1, geom.tphi1)
    Pt = torch.einsum("q,tqi,tqj->tij", geom.wqf, geom.tphi1, geom.tphi1)
    six = torch.arange(6, device=dev)[:, None]
    Ct = star_bl.new_zeros((6, geom.wqf.shape[0], geom.n_cells))
    NNt = star_bl.new_zeros((6, 2, 2, geom.n_cells))  # dense tables' penalty
    sn_slots = slot_values(geom, snq)
    flen_slots = slot_values(geom, table_ext(geom, "flen"), ext=True)
    if not factored:
        hfi_slots = slot_values(geom, table_ext(geom, "hF_inv"), ext=True)
        nrm_slots = slot_values(geom, table_ext(geom, "normal"), ext=True)
    for l in range(3):
        sn_l, flen_l = sn_slots[l], flen_slots[l]
        int_l = 1.0 - geom.cf_bnd[l].to(dtype)
        w_l = geom.wqf[:, None] * flen_l[None, :]
        coeff = (-c) * (0.5 * geom.cfsign[l] * sn_l - upw * torch.abs(sn_l)) * w_l * int_l
        onehot = (geom.cf_tab[l][None, :] == six).to(dtype)
        Ct = Ct + onehot[:, None, :] * coeff[None, :, :]
        if not factored:
            n_l = nrm_slots[l]
            pen_l = c * alpha * hfi_slots[l] * flen_l
            nn_l = n_l[:, None, :] * n_l[None, :, :]
            NNt = NNt + onehot[:, None, None, :] * (pen_l * nn_l)[None]
    S_own = (S_own + torch.einsum("tijq,tqc->ijc", Gt, Ct)).contiguous()

    # scalar cross blocks
    U0 = geom.tphi1[geom.ftab[0]]  # (nf, nqf, d1)
    U1 = geom.tphi1[geom.ftab[1]]
    msk = interior_mask(geom, 1)
    wf = geom.wqf[:, None] * geom.flen[None, :]
    s01 = (-c) * (-0.5 * snq + upw * torch.abs(snq)) * wf * msk[None, :]
    s10 = (-c) * (0.5 * snq + upw * torch.abs(snq)) * wf * msk[None, :]
    K01s = torch.einsum("fqi,fqj,qf->ijf", U0, U1, s01).contiguous()
    K10s = torch.einsum("fqi,fqj,qf->ijf", U1, U0, s10).contiguous()
    store = pc_dtype or dtype
    if factored:
        return _build_factored(geom, S_own, K01s, K10s, Pt, c, alpha, store, reuse_factors)

    # dense tables: D = I2 (x) Sown + sum_t Pt (x) NNt, Bx = I2 (x) Ks01 +
    # penalty (n (x) n) (x) K01p, Cx likewise
    nu = 2 * d1
    D_bl = _kron2(S_own) + torch.einsum("tij,tabc->aibjc", Pt, NNt).reshape(nu, nu, -1)
    penf = (-c) * alpha * geom.hF_inv * msk
    nnf = geom.normal[:, None, :] * geom.normal[None, :, :]
    K01p = torch.einsum("fqi,fqj,qf->ijf", U0, U1, wf) * penf
    K10p = torch.einsum("fqi,fqj,qf->ijf", U1, U0, wf) * penf
    Bx = _kron2(K01s) + torch.einsum("abf,ijf->aibjf", nnf, K01p).reshape(nu, nu, -1)
    Cx = _kron2(K10s) + torch.einsum("abf,ijf->aibjf", nnf, K10p).reshape(nu, nu, -1)
    if reuse_factors is not None:
        rf = reuse_factors
        return TentativeOperator(Dinv=rf.Dinv, Sinv=rf.Sinv, Dinv0=rf.Dinv0, D=D_bl, Bx=Bx, Cx=Cx)
    with span("tentative_inverse", dev):
        Dinv_bl = gauss_jordan_inv_bl(D_bl)
        if geom.shift is not None:  # IEHDG_FACT=0 on a structured mesh
            Sinv, Dinv0 = _schur_structured(
                geom, D_bl, Dinv_bl, lambda k, b0, b1: (Bx[:, :, b0:b1], Cx[:, :, b0:b1]), store)
            return TentativeOperator(Dinv=Dinv_bl, Sinv=Sinv, Dinv0=Dinv0, D=D_bl, Bx=Bx, Cx=Cx)
        # patch Schur factors of every facet; identity blocks on the boundary
        if geom.part is None:
            Dinv0, D1 = Dinv_bl[:, :, geom.fcells[0]], D_bl[:, :, geom.fcells[1]]
        else:  # the ghost cells' blocks, one exchange
            both = cells_ext(geom, torch.stack([Dinv_bl, D_bl]))
            Dinv0, D1 = both[0][:, :, geom.fcells[0]], both[1][:, :, geom.fcells[1]]
        Sc = D1 - _bmm(Cx, _bmm(Dinv0, Bx))
        eye = torch.eye(nu, dtype=dtype, device=dev)[:, :, None]
        Sc = torch.where(msk[None, None, :] > 0, Sc, eye)
        Sinv = gauss_jordan_inv_bl(Sc).to(store)
    return TentativeOperator(Dinv=Dinv_bl, Sinv=Sinv, Dinv0=Dinv0.to(store), D=D_bl, Bx=Bx,
                             Cx=Cx)


def _build_factored(geom, S_own, K01s, K10s, Pt, c, alpha, store, reuse_factors=None):
    """The factored tables of a uniform structured mesh and their Schwarz
    factors, colour by colour (K4 on each colour's Schur blocks) and stored
    in ``store``, or the factors of ``reuse_factors``."""
    d1 = geom.d1
    nu = 2 * d1
    dtype, dev = S_own.dtype, S_own.device

    # own-cell penalty: a constant per cell half (congruent facets)
    Pcell = []
    for h in (0, 1):
        Ph = S_own.new_zeros((2, d1, 2, d1))
        for (t, _ln, nx_, ny_) in geom.uniform[1][h]:
            nvec = torch.tensor([nx_, ny_], dtype=dtype, device=dev)
            nn = nvec[:, None] * nvec[None, :]
            Ph = Ph + (c * alpha) * nn[:, None, :, None] * Pt[t][None, :, None, :]
        Pcell.append(Ph.reshape(nu, nu))
    Pcell = torch.stack(Pcell)

    # per-colour constant cross penalties
    K01s, K10s = pad_table(K01s), pad_table(K10s)
    Bp, Cp = [], []
    for (t0, t1, _ln, nx_, ny_) in geom.uniform[0]:
        PM = torch.einsum("q,qi,qj->ij", geom.wqf, geom.tphi1[t0], geom.tphi1[t1])
        nvec = torch.tensor([nx_, ny_], dtype=dtype, device=dev)
        nn = nvec[:, None] * nvec[None, :]
        coef = (-c) * alpha
        Bp.append(coef * (nn[:, None, :, None] * PM[None, :, None, :]).reshape(nu, nu))
        Cp.append(coef * (nn[:, None, :, None] * PM.T[None, :, None, :]).reshape(nu, nu))
    Bp = torch.stack(Bp)
    Cp = torch.stack(Cp)
    tables = dict(Sown=S_own, Pcell=Pcell, Ks01=K01s, Ks10=K10s, Bp=Bp, Cp=Cp)
    if reuse_factors is not None:
        rf = reuse_factors
        return TentativeOperator(Dinv=rf.Dinv, Sinv=rf.Sinv, Dinv0=rf.Dinv0, **tables)

    nch = geom.shift[0] * geom.shift[1]
    D_bl = _kron2(S_own)
    D_bl[:, :, :nch] += Pcell[0][:, :, None]
    D_bl[:, :, nch:] += Pcell[1][:, :, None]

    def cross(k, b0, b1):
        return (_kron2(K01s[:, :, b0:b1]) + Bp[k][:, :, None],
                _kron2(K10s[:, :, b0:b1]) + Cp[k][:, :, None])

    with span("tentative_inverse", dev):
        Dinv_bl = gauss_jordan_inv_bl(D_bl)
        Sinv, Dinv0 = _schur_structured(geom, D_bl, Dinv_bl, cross, store)
    return TentativeOperator(Dinv=Dinv_bl, Sinv=Sinv, Dinv0=Dinv0, **tables)


def _schur_structured(geom, D_bl, Dinv_bl, cross, store):
    """The patch factors of a structured mesh, colour by colour on the
    rectangle layout (preconditioners.py:491-611): each colour's plus-cell
    inverses Dinv0 and Schur inverses Sinv of S = D_minus - Cx Dinv0 Bx
    (K4), with ``cross(k, b0, b1)`` the colour's dense (Bx, Cx) blocks; on
    the boundary tail, identity Schur blocks and the plus cells' inverses.
    Returns padded (Sinv, Dinv0) tables (:func:`pad_table`) of dtype
    ``store``, each part cast after its inversion."""
    nu = D_bl.shape[0]
    dtype, dev = D_bl.dtype, D_bl.device
    Dup = st.grid_halves(geom, D_bl)[1]
    Dinv_lo = st.grid_halves(geom, Dinv_bl)[0]
    Sinv_parts, Dinv0_parts = [], []
    for k, (l, lu, i0, j0, ni, nj, off) in enumerate(geom.shift[4]):
        rect = (i0, j0, ni, nj)
        b0, b1 = geom.fcol_bounds[k], geom.fcol_bounds[k + 1]
        D1 = st.rect_flat(st.roll2(geom, Dup, off), rect)
        Dinv0_k = st.rect_flat(Dinv_lo, rect)
        Dinv0_parts.append(Dinv0_k.to(store))
        Bx_k, Cx_k = cross(k, b0, b1)
        Sc = D1 - _bmm(Cx_k, _bmm(Dinv0_k, Bx_k))
        if geom.fint is not None:
            # slab-local layout: the colour rectangles hold boundary and
            # dummy positions; identity Schur blocks there (the patch solve
            # masks their corrections)
            eye = torch.eye(nu, dtype=dtype, device=dev)[:, :, None]
            Sc = torch.where(geom.fint[b0:b1][None, None, :] > 0, Sc, eye)
        Sinv_parts.append(gauss_jordan_inv_bl(Sc).to(store))
    nbnd = geom.n_facets - geom.n_int
    if nbnd:
        eye = torch.eye(nu, dtype=store, device=dev)
        Sinv_parts.append(eye[:, :, None].expand(nu, nu, nbnd))
        Dinv0_parts.append(Dinv_bl[:, :, geom.fcells[0, geom.n_int :]].to(store))
    return _cat_table(Sinv_parts), _cat_table(Dinv0_parts)


def dense_blocks(geom, op):
    """Dense (D (nu, nu, nc), Bx (nu, nu, nf), Cx) tables of an operator:
    its own on a dense one, expanded from a factored one (test helper; the
    factored hot paths never materialise them)."""
    if op.Sown is None:
        return op.D, op.Bx, op.Cx
    nch = geom.shift[0] * geom.shift[1]
    D = _kron2(op.Sown)
    D[:, :, :nch] += op.Pcell[0][:, :, None]
    D[:, :, nch:] += op.Pcell[1][:, :, None]
    b = geom.fcol_bounds
    msk = interior_mask(geom, 1)

    def expand(Ks, Pk):
        X = _kron2(Ks)
        pen = torch.zeros_like(X)
        for k in range(len(b) - 1):
            pen[:, :, b[k] : b[k + 1]] = Pk[k][:, :, None]
        return X + pen * msk

    return D, expand(op.Ks01, op.Bp), expand(op.Ks10, op.Cp)


# ----------------------------------------------------------------------
# operator application and the fused colored sweep
# ----------------------------------------------------------------------


def _cross_pair_full(geom, op, u0, u1):
    """Both full-field cross applies: (Ks01 + Bp) u1 and (Ks10 + Cp) u0."""
    return cross_pair(op.Ks01, op.Ks10, op.Bp, op.Cp, geom.fcol_bounds, u0, u1)


def _cross_pair_color(geom, op, k, x0, x1):
    """Both cross applies of colour k on its facet values."""
    b0 = geom.fcol_bounds[k]
    return cross_pair(op.Ks01, op.Ks10, op.Bp[k : k + 1], op.Cp[k : k + 1],
                      (0, x0.shape[1]), x0, x1, aoff=b0)


def _gather_sides_bl(geom, ub):
    """Plus and minus cell columns of a (nu, nc) field at every facet, the
    minus side zero on boundary facets: two (nu, nf) moves."""
    u0, u1 = gather_sides(geom, ub)
    return u0, u1 if geom.shift is not None else u1 * interior_mask(geom, 2)


def _matvec_bl(geom, op, ub):
    """Assembled operator on a component-major (nu, nc) field."""
    u0, u1 = _gather_sides_bl(geom, ub)
    if op.Sown is None:
        r, z0, z1 = _bm(op.D, ub), _bm(op.Bx, u1), _bm(op.Cx, u0)
        return r + gather_facet_contribs(geom, z0, z1 * interior_mask(geom, 2))
    # K2 before K1, with the gather between them: PyTorch work on both
    # sides of each launch, so a graph's capture cuts no empty graph
    # (kernels.graph_cut)
    z0, z1 = _cross_pair_full(geom, op, u0, u1)
    z = gather_facet_contribs(geom, z0, z1 * interior_mask(geom, 2))
    nch = geom.shift[0] * geom.shift[1]
    return fact_apply(op.Sown, op.Pcell, (0, nch, geom.n_cells), ub) + z


def tentative_operator_matvec(geom, op, u):
    """Assembled operator M - c f_impl of ``op`` on a (2, d1, nc) field."""
    _, d1, nc = u.shape
    return _matvec_bl(geom, op, u.reshape(2 * d1, nc)).reshape(u.shape)


def _patch_color_structured(geom, op, k, rb):
    """Exact solves of colour k's facet-pair patches on a (nu, nc) residual;
    zero on cells without a colour-k facet."""
    l, lu, i0, j0, ni, nj, off = geom.shift[4][k]
    rect = (i0, j0, ni, nj)
    lo, up = st.grid_halves(geom, rb)
    r0 = st.rect_flat(lo, rect)
    r1 = st.rect_flat(st.roll2(geom, up, off), rect)
    b0, b1 = geom.fcol_bounds[k], geom.fcol_bounds[k + 1]
    if op.Sown is not None:
        y0, y1 = patch_solve(op.Dinv0, op.Sinv, op.Ks01, op.Ks10, op.Bp[k], op.Cp[k],
                             r0, r1, b0)
    else:  # dense tables (IEHDG_FACT=0)
        y0, y1 = _patch_dense(op, b0, b1, r0, r1)
    if geom.fint is not None:
        # slab-local layout: no correction at the boundary and dummy
        # positions inside the colour rectangle
        y0, y1 = y0 * geom.fint[b0:b1], y1 * geom.fint[b0:b1]
    z_lo = st.rect_pad(geom, y0, rect)
    z_up = st.roll2(geom, st.rect_pad(geom, y1, rect), (-off[0], -off[1]))
    return st.grid_join(geom, z_lo, z_up)


def _patch_dense(op, b0, b1, r0, r1):
    """The patch solves of facets b0 .. b1 - 1 on dense tables (the JAX
    ``_bm`` composition, preconditioners.py:1381-1385)."""
    Dinv0 = op.Dinv0[:, :, b0:b1]
    t = r1 - _bm(op.Cx[:, :, b0:b1], _bm(Dinv0, r0))
    y1 = _bm(op.Sinv[:, :, b0:b1], t)
    return _bm(Dinv0, r0 - _bm(op.Bx[:, :, b0:b1], y1)), y1


def _patch_color(geom, op, k, rb):
    """Exact solves of colour k's facet-pair patches on dense tables, moved
    by index gathers: (nu, nc) residual -> (nu, nc), zero on cells without
    a colour-k facet.  On a partition the corrections go back to the cells
    through the facet-to-cell gather of every facet, zero off colour k
    (each cell has at most one colour-k facet, so the sum of its three
    slots is the one correction)."""
    b0, b1 = geom.fcol_bounds[k], geom.fcol_bounds[k + 1]
    rb = cells_ext(geom, rb)
    r0 = rb[:, geom.fcells[0, b0:b1]]
    r1 = rb[:, geom.fcells[1, b0:b1]]
    y0, y1 = _patch_dense(op, b0, b1, r0, r1)
    if geom.part is not None:
        y = y0.new_zeros((2, y0.shape[0], geom.n_facets))
        y[0, :, b0:b1], y[1, :, b0:b1] = y0, y1
        return gather_facet_contribs(geom, y[0], y[1])
    ycat = torch.cat([y0, y1], dim=1)
    idx = geom.fcol_pos[k] + geom.fcol_side[k] * (b1 - b0)
    return ycat[:, idx] * geom.fcol_mask[k][None, :]


def _sweep_colours(geom, symmetric):
    """The colours of one multiplicative sweep: the mesh's order
    (:func:`structured.sweep_order`), then back unless it is the last."""
    first = list(st.sweep_order(geom))
    return first + (first[-2::-1] if symmetric else [])


def _colored_apply_bl(geom, op, rb, symmetric=False):
    """Multiplicative colored sweep on a (nu, nc) residual, with one full
    matvec between colours; ``symmetric`` sweeps back through the colours.
    Needs every cell to carry an interior facet (true of every mesh the
    port builds but the 1x1 square)."""
    if geom.fcol_orphans:
        raise ValueError("the colored sweep needs every cell to carry an interior facet")
    patch = _patch_color_structured if geom.shift is not None else _patch_color
    order = _sweep_colours(geom, symmetric)
    z = patch(geom, op, order[0], rb)
    for k in order[1:]:
        z = z + patch(geom, op, k, rb - _matvec_bl(geom, op, z))
    return z


def tentative_colored_apply(geom, op, r, symmetric=False):
    """Multiplicative colored facet-pair Schwarz sweep on a (2, d1, nc)
    residual (preconditioners.py:1522)."""
    _, d1, nc = r.shape
    return _colored_apply_bl(geom, op, r.reshape(2 * d1, nc), symmetric).reshape(r.shape)


def _patch_apply_bl(geom, op, rb):
    """Additive Schwarz on a (nu, nc) residual (preconditioners.py:1274-1306):
    every facet's patch solve from the same residual, the minus side zero on
    the boundary, summed into the cells with weight 1/3.  On factored
    tables the solves are K3, one launch per colour and one for the
    boundary tail with zero penalty blocks (there the patch solve reduces
    to the plus cell's inverse, as in the JAX package)."""
    if geom.fint is not None:
        raise NotImplementedError("the additive patch preconditioner on a slab-local layout")
    msk = interior_mask(geom, 1)
    r0, r1 = _gather_sides_bl(geom, rb)
    r1 = r1 * msk
    if op.Sown is None:
        y0, y1 = _patch_dense(op, 0, geom.n_facets, r0, r1)
        y1 = y1 * msk
    else:
        b = list(geom.fcol_bounds)
        parts = [patch_solve(op.Dinv0, op.Sinv, op.Ks01, op.Ks10, op.Bp[k], op.Cp[k],
                             r0[:, b[k]:b[k + 1]], r1[:, b[k]:b[k + 1]], b[k])
                 for k in range(len(b) - 1)]
        if geom.n_facets > b[-1]:
            zero = op.Bp.new_zeros(op.Bp.shape[1:])
            parts.append(patch_solve(op.Dinv0, op.Sinv, op.Ks01, op.Ks10, zero, zero,
                                     r0[:, b[-1]:], r1[:, b[-1]:], b[-1]))
        y0 = torch.cat([y[0] for y in parts], dim=1)
        y1 = torch.cat([y[1] for y in parts], dim=1)
    return gather_facet_contribs(geom, y0, y1) / 3.0


def tentative_patch_apply(geom, op, r):
    """Additive facet-patch Schwarz preconditioner on a (2, d1, nc)
    residual (preconditioners.py:1309-1319)."""
    _, d1, nc = r.shape
    return _patch_apply_bl(geom, op, r.reshape(2 * d1, nc)).reshape(r.shape)


def _color_cov(geom, k):
    """(nc,) mask of the cells colour k's patches cover."""
    l, lu, i0, j0, ni, nj, off = geom.shift[4][k]
    b0, b1 = geom.fcol_bounds[k], geom.fcol_bounds[k + 1]
    fk = geom.fint[b0:b1] if geom.fint is not None else \
        torch.ones(b1 - b0, dtype=geom.dtype, device=geom.device)
    lo = st.rect_pad(geom, fk, (i0, j0, ni, nj))
    return st.grid_join(geom, lo, st.roll2(geom, lo, (-off[0], -off[1])))


def _cross_offcolor(geom, op, k, dz):
    """Cross-coupling part of ``A dz`` through the facets of colours != k."""
    lo_dz, up_dz = st.grid_halves(geom, dz)
    acc_lo = 0.0
    acc_up = 0.0
    for j, (l, lu, i0, j0, ni, nj, off) in enumerate(geom.shift[4]):
        if j == k:
            continue
        rect = (i0, j0, ni, nj)
        z0 = st.rect_flat(lo_dz, rect)
        z1 = st.rect_flat(st.roll2(geom, up_dz, off), rect)
        b0, b1 = geom.fcol_bounds[j], geom.fcol_bounds[j + 1]
        if op.Sown is not None:
            y0, y1 = _cross_pair_color(geom, op, j, z0, z1)
        else:  # dense tables (IEHDG_FACT=0)
            y0, y1 = _bm(op.Bx[:, :, b0:b1], z1), _bm(op.Cx[:, :, b0:b1], z0)
        if geom.fint is not None:
            y0, y1 = y0 * geom.fint[b0:b1], y1 * geom.fint[b0:b1]
        acc_lo = acc_lo + st.rect_pad(geom, y0, rect)
        acc_up = acc_up + st.roll2(geom, st.rect_pad(geom, y1, rect), (-off[0], -off[1]))
    return st.grid_join(geom, acc_lo, acc_up)


def _colored_apply_fused_bl(geom, op, vb, symmetric=True, exact_Az=True):
    """Multiplicative colored sweep (colours forward, then back unless
    ``symmetric`` is False) returning ``z = M v`` and ``A z``: the exact
    one (one explicit matvec at the end), or with ``exact_Az`` False
    (``IEHDG_TENT_FUSED=2``) the free ``A z = v - r`` of the incremental
    residual, the last colour's residual update run like the others' and
    no matvec (on factored tables one K1 and one K2 full-field launch
    fewer; exact in exact arithmetic, its rounding as the JAX package's,
    preconditioners.py:1479-1517).

    Each colour's pair solves are exact and each cell has at most one facet
    per colour, so the residual after a colour is ``-(off-colour cross)(dz)``
    on its patch cells and ``r - (off-colour cross)(dz)`` elsewhere: no
    matvec between colours.  Needs every cell to carry an interior facet.
    On factored tables a colour is one K3 launch and each off-colour update
    one K2 launch per other colour; on dense tables (``IEHDG_FACT=0``) both
    are ``einsum``s.
    """
    if geom.fcol_orphans:
        raise ValueError("the fused sweep needs every cell to carry an interior facet")
    order = _sweep_colours(geom, symmetric)
    z = None
    r = vb
    for i, k in enumerate(order):
        dz = _patch_color_structured(geom, op, k, r)
        z = dz if z is None else z + dz
        if exact_Az and i == len(order) - 1:
            return z, _matvec_bl(geom, op, z)
        r = r * (1.0 - _color_cov(geom, k))[None, :] - _cross_offcolor(geom, op, k, dz)
    return z, vb - r

"""Carry the JAX package's objects over to the port, through numpy.

The parity tests build one object with the JAX package, convert it here, and
feed both packages identical tables and states, so that each layer is tested
on its own.  Nothing here imports JAX: the JAX objects are read through
their attributes and ``numpy.asarray``.
"""

import numpy as np
import torch

from .fem.discretisation import Geom
from .linalg.condense import CondensedSystem
from .linalg.gtmg import TwoLevelTracePC
from .linalg.preconditioners import TentativeOperator
from .ops.projection import BDMProjection

__all__ = [
    "tensor",
    "geom_from_jax",
    "state_from_jax",
    "bdm_from_jax",
    "tentative_operator_from_jax",
    "condensed_system_from_jax",
    "gtmg_from_jax",
]


def tensor(a, dtype=torch.float64, device="cpu"):
    """A JAX/numpy array as a tensor: floats to ``dtype``, integers to int64."""
    a = np.asarray(a)
    if a.dtype.kind in "iu":
        return torch.as_tensor(a.astype(np.int64), device=device)
    if a.dtype.kind == "b":
        return torch.as_tensor(a, device=device)
    return torch.as_tensor(a.astype(np.float64), dtype=dtype, device=device)


def geom_from_jax(disc, dtype=torch.float64, device="cpu"):
    """The port's Geom from a JAX HDGDiscretisation's host tables."""
    return Geom.from_arrays(disc._geom_host, dtype, device)


def state_from_jax(arrays, dtype=torch.float64, device="cpu"):
    """A list of JAX stage arrays (Q, p or lam) as tensors."""
    return [tensor(a, dtype, device) for a in arrays]


def bdm_from_jax(proj, dtype=torch.float64, device="cpu"):
    """BDMProjection tables from the JAX package's."""
    t = lambda a: tensor(a, dtype, device)
    return BDMProjection(leg=t(proj.leg), vhat=t(proj.vhat), recon=t(proj.recon),
                         class_id=t(proj.class_id), n_moments=proj.n_moments,
                         n_interior_dofs=proj.n_interior_dofs)


def tentative_operator_from_jax(op, dtype=torch.float64, device="cpu"):
    """A flat factored TentativeOperator from the JAX package's (the branch
    JAX builds off the TPU: 3-D tables, Sown not None)."""
    if op.Sown is None or np.ndim(op.Ks01) != 3:
        raise ValueError("expected a flat factored TentativeOperator")
    t = lambda a: tensor(a, dtype, device)
    return TentativeOperator(Dinv=t(op.Dinv), Sinv=t(op.Sinv), Dinv0=t(op.Dinv0),
                             Sown=t(op.Sown), Pcell=t(op.Pcell), Ks01=t(op.Ks01),
                             Ks10=t(op.Ks10), Bp=t(op.Bp), Cp=t(op.Cp))


def condensed_system_from_jax(cs, dtype=torch.float64, device="cpu"):
    """CondensedSystem tables from the JAX package's."""
    t = lambda a: tensor(a, dtype, device)
    return CondensedSystem(S=t(cs.S), Ainv=t(cs.Ainv), AinvB=t(cs.AinvB),
                           CAinv=t(cs.CAinv), class_id=t(cs.class_id),
                           Sdiag_inv=t(cs.Sdiag_inv), nullvec=t(cs.nullvec),
                           tau=float(cs.tau), nt=int(cs.nt))


def gtmg_from_jax(pc, dtype=torch.float64, device="cpu"):
    """The structured (fft_neumann) two-level preconditioner from the JAX
    package's."""
    if pc.coarse_kind != "fft_neumann" or pc.vshift is None:
        raise ValueError("expected a structured fft_neumann TwoLevelTracePC")
    t = lambda a: tensor(a, dtype, device)
    return TwoLevelTracePC(
        Sdiag_inv=t(pc.Sdiag_inv), trace_nodes=t(pc.trace_nodes),
        sign=float(np.asarray(pc.sign)), coarse_eig_inv=t(pc.coarse_eig_inv),
        coarse_scale=t(pc.coarse_scale), vshift=pc.vshift,
        n_vertices=int(pc.n_vertices), grid_shape=tuple(pc.grid_shape),
        cheb_fine=int(pc.cheb_fine), lmax_fine=float(pc.lmax_fine),
    )

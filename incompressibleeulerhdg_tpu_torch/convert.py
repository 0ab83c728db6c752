"""Carry the JAX package's objects over to the port, through numpy.

The parity tests build one object with the JAX package, convert it here, and
feed both packages identical tables and states, so that each layer is tested
on its own.  Nothing here imports JAX: the JAX objects are read through
their attributes and ``numpy.asarray``.
"""

from dataclasses import fields

import numpy as np
import torch

from .fem.cg import CGSpace
from .fem.discretisation import Geom
from .linalg.condense import CondensedSystem
from .linalg.gtmg import TwoLevelTracePC
from .linalg.preconditioners import TentativeOperator
from .ops.projection import BDMProjection
from .ops.rt import RTTables, facet_slots

__all__ = [
    "tensor",
    "geom_from_jax",
    "state_from_jax",
    "bdm_from_jax",
    "tentative_operator_from_jax",
    "condensed_system_from_jax",
    "gtmg_from_jax",
    "rt_tables_from_jax",
    "cg_space_from_jax",
    "slab_decomposition_from_jax",
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
    """A TentativeOperator from the JAX package's flat branches (the ones
    JAX builds off the TPU): factored (3-D ``Ks01``, uniform structured
    meshes) or dense (``D``, ``Bx``, ``Cx``; unstructured meshes, and
    structured ones under ``IEHDG_FACT=0``), lagged builds
    (``reuse_factors``) included.  Patch factors stored in bfloat16
    (``pc_dtype``) stay bfloat16, bit for bit."""
    names = ("Dinv", "Sinv", "Dinv0")
    if op.Sown is not None and np.ndim(op.Ks01) == 3:
        names += ("Sown", "Pcell", "Ks01", "Ks10", "Bp", "Cp")
    elif op.Sown is None and op.D is not None:
        names += ("D", "Bx", "Cx")
    else:
        raise ValueError("expected a flat factored or dense TentativeOperator")

    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":  # exact through float32
            return torch.as_tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
        return tensor(a, dtype, device)

    return TentativeOperator(**{n: conv(getattr(op, n)) for n in names})


def condensed_system_from_jax(cs, dtype=torch.float64, device="cpu"):
    """CondensedSystem tables from the JAX package's."""
    t = lambda a: tensor(a, dtype, device)
    return CondensedSystem(S=t(cs.S), Ainv=t(cs.Ainv), AinvB=t(cs.AinvB),
                           CAinv=t(cs.CAinv), class_id=t(cs.class_id),
                           Sdiag_inv=t(cs.Sdiag_inv), nullvec=t(cs.nullvec),
                           tau=float(cs.tau), nt=int(cs.nt))


def gtmg_from_jax(pc, dtype=torch.float64, device="cpu", comm=None):
    """The two-level preconditioner from the JAX package's (any coarse
    kind; the JAX-only ``fft_f32`` field is not carried).  A slab's
    preconditioner (``dist`` set: one slab of the JAX package's stacked
    tables) gets ``comm`` in place of the JAX axis name."""
    t = lambda a: None if a is None else tensor(a, dtype, device)
    dist = None if pc.dist is None else (comm,) + tuple(pc.dist[1:])
    structured = pc.coarse_kind != "cheb"
    return TwoLevelTracePC(
        Sdiag_inv=t(pc.Sdiag_inv), trace_nodes=t(pc.trace_nodes),
        sign=float(np.asarray(pc.sign)), facet_verts=t(pc.facet_verts),
        K_elem=t(pc.K_elem), cells=t(pc.cells), K_diag_inv=t(pc.K_diag_inv),
        vf=t(pc.vf), vf_end=t(pc.vf_end), vf_mask=t(pc.vf_mask),
        vc=t(pc.vc), vc_pos=t(pc.vc_pos), vc_mask=t(pc.vc_mask),
        coarse_eig_inv=t(pc.coarse_eig_inv) if structured else None,
        coarse_scale=t(pc.coarse_scale) if pc.coarse_kind == "fft_neumann" else None,
        star_inv=t(pc.star_inv), star_pos=t(pc.star_pos),
        coarse_dense_inv=t(pc.coarse_dense_inv), vshift=pc.vshift,
        n_vertices=int(pc.n_vertices), coarse_kind=pc.coarse_kind,
        grid_shape=None if pc.grid_shape is None else tuple(pc.grid_shape),
        cheb_fine=int(pc.cheb_fine), cheb_coarse=int(pc.cheb_coarse),
        lmax_fine=float(pc.lmax_fine), lmax_coarse=float(pc.lmax_coarse), dist=dist,
    )


def rt_tables_from_jax(rt, geom, dtype=torch.float64, device="cpu"):
    """RTTables from the JAX package's, with the facet slots of the port's
    ``geom`` (the JAX package scatters instead)."""
    t = lambda a: tensor(a, dtype, device)
    return RTTables(P_opp=t(rt.P_opp), area=t(rt.area), mass_elem=t(rt.mass_elem),
                    mass_diag_inv=t(rt.mass_diag_inv), xqf=t(rt.xqf), bnd_mask=t(rt.bnd_mask),
                    int_dof_mask=t(rt.int_dof_mask), fslot=facet_slots(geom))


def cg_space_from_jax(space, dtype=torch.float64, device="cpu"):
    """A CGSpace from the JAX package's."""
    t = lambda a: tensor(a, dtype, device)
    return CGSpace(dofmap=tensor(space.dofmap, device=device), phi_at_q1=t(space.phi_at_q1),
                   mass_diag=t(space.mass_diag), node_coords=t(space.node_coords),
                   degree=int(space.degree), n_dofs=int(space.n_dofs))


def slab_decomposition_from_jax(dec, rank, dtype=torch.float64, device="cpu", comm=None):
    """Slab ``rank`` of a JAX ``SlabDecomposition`` as the port's tables: its
    stacked per-slab arrays (taken at ``rank``, as numpy) become the
    ``geom``, ``cs``, ``proj`` and ``pc`` of the port's
    ``parallel.slab.SlabDecomposition``, with ``comm`` in place of the JAX
    axis name in the geometry's spec and the GTMG transfers; also the slab's
    index maps and masks.  Returns a dict of those names.  The JAX
    package's slab sweeps its colours in their stored order (by plus slot),
    which the spec's sweep order keeps."""
    at = lambda tree: _slab_slice(tree, rank)
    jg = at(dec.geom)
    shift = tuple(jg.shift[:6]) + ((comm, jg.shift[6][1], tuple(range(len(jg.shift[4])))),)
    arrays = {f.name: getattr(jg, f.name, None) for f in fields(Geom)}
    arrays.update(shift=shift, uniform=jg.uniform, fcol_bounds=tuple(jg.fcol_bounds))
    pc = at(dec.pc)
    return dict(
        geom=Geom.from_arrays(arrays, dtype, device),
        cs=condensed_system_from_jax(at(dec.cs), dtype, device),
        proj=bdm_from_jax(at(dec.proj), dtype, device),
        pc=gtmg_from_jax(pc, dtype, device, comm=comm),
        cell_map=np.asarray(dec.cell_maps[rank]), facet_map=np.asarray(dec.facet_maps[rank]),
        cell_valid=np.asarray(dec.cell_valid[rank]),
        facet_valid=np.asarray(dec.facet_valid[rank]),
    )


def _slab_slice(tree, rank):
    """One slab of a JAX stacked dataclass: every array field at ``rank``
    (numpy), every other field as it is."""
    kw = {}
    for f in fields(tree):
        v = getattr(tree, f.name)
        kw[f.name] = np.asarray(v)[rank] if hasattr(v, "shape") and np.ndim(v) > 0 else v
    return type(tree)(**kw)

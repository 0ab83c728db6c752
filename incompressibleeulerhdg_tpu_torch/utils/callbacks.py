"""Per-timestep callbacks: animation output with derived vorticity.

Counterpart of incompressibleeulerhdg_tpu/utils/callbacks.py: the
``Callback`` base class and ``AnimationCallback``, which writes velocity,
pressure, vorticity and (with a tracer) the tracer, sampled at the cell
corners, to a VTK time series after every step.  The vorticity projection
(the CG(k+2) weak curl, ``ops/vorticity.py``) is built on first use.
"""

from abc import ABC, abstractmethod

import numpy as np
import torch

from .vtk import _CORNERS, VTKTimeSeries, sample_dg_at_corners

__all__ = ["Callback", "AnimationCallback"]


class Callback(ABC):
    """A function of the fields after each timestep."""

    @abstractmethod
    def __call__(self, Q, p, t, q_tracer=None):
        """Invoke the callback for the fields at time ``t``."""

    @abstractmethod
    def reset(self):
        """Reset the callback at the start of a run."""


class AnimationCallback(Callback):
    """Save the fields and the derived vorticity to a VTK time series.

    :arg disc: HDGDiscretisation
    :arg filename: .pvd output path
    """

    def __init__(self, disc, filename):
        self.disc = disc
        self.filename = filename
        self._vort = None
        self.reset()

    def reset(self):
        self.outfile = VTKTimeSeries(self.filename)

    def _vorticity_solver(self):
        """(CG space of the velocity's degree, Q -> vorticity dofs), built on
        first use."""
        if self._vort is None:
            from ..fem.cg import build_cg_space
            from ..fem.lagrange import triangle_basis
            from ..fem.spaces import facet_ref_points
            from ..ops.vorticity import vorticity_project

            disc = self.disc
            degree = disc.degree + 1
            space = build_cg_space(disc, degree)
            basis = triangle_basis(degree)
            t = lambda a: torch.as_tensor(a, dtype=disc.dtype, device=disc.device)
            gphi = t(basis.tabulate_grad(disc.V1.qp))
            tphi = t(np.stack([basis.tabulate(facet_ref_points(l, flip, disc.Vt.sq))
                               for l in range(3) for flip in (0, 1)]))
            self._vort = (space, basis,
                          lambda Q: vorticity_project(disc, space, Q, gphi, tphi)[0])
        return self._vort

    def __call__(self, Q, p, t, q_tracer=None):
        disc = self.disc
        space, basis, project = self._vorticity_solver()
        # the CG vorticity at the cell corners
        loc = project(Q)[space.dofmap].cpu().numpy()  # (nloc, nc)
        omega_corners = np.einsum("pi,ic->cp", basis.tabulate(_CORNERS), loc)
        host = lambda a: a.detach().cpu().numpy()
        fields = {
            "velocity": sample_dg_at_corners(disc, host(Q)),
            "pressure": sample_dg_at_corners(disc, host(p)),
            "vorticity": omega_corners,
        }
        if q_tracer is not None:
            fields["tracer"] = sample_dg_at_corners(disc, host(q_tracer))
        self.outfile.write(disc.mesh, fields, time=float(t))

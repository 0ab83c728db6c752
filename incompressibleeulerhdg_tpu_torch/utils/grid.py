"""Mesh utility functions: the port's own copy of
incompressibleeulerhdg_tpu/utils/grid.py (numpy only)."""

import numpy as np

__all__ = ["gridspacing"]


def gridspacing(mesh):
    """Smallest and largest edge length of a 2-D mesh."""
    return float(np.min(mesh.facet_lengths)), float(np.max(mesh.facet_lengths))

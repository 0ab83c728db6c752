"""Triangle meshes of the port: the port's own copies of the JAX package's
numpy mesh modules (``triangle_mesh``, the unit-square generator) and of its
C++ connectivity kernel (``native``)."""

from .generators import unit_square_mesh
from .triangle_mesh import LOCAL_FACET_VERTS, TriangleMesh, build_mesh

__all__ = ["unit_square_mesh", "build_mesh", "TriangleMesh", "LOCAL_FACET_VERTS"]

"""Triangle meshes of the port: the port's own copies of the JAX package's
numpy mesh modules (``triangle_mesh``, the three generators) and of its C++
connectivity kernel (``native``)."""

from .generators import periodic_square_mesh, unit_disk_mesh, unit_square_mesh
from .triangle_mesh import LOCAL_FACET_VERTS, TriangleMesh, build_mesh

__all__ = ["unit_square_mesh", "periodic_square_mesh", "unit_disk_mesh", "build_mesh",
           "TriangleMesh", "LOCAL_FACET_VERTS"]

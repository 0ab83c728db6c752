"""Mesh generators of the port: the JAX package's numpy-only ``mesh`` modules
(with their C++ connectivity kernel), imported rather than copied."""

from incompressibleeulerhdg_tpu.mesh.generators import unit_square_mesh

__all__ = ["unit_square_mesh"]

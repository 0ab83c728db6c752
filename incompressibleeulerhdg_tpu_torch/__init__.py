"""incompressibleeulerhdg_tpu_torch -- the HDG incompressible Euler solver in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``incompressibleeulerhdg_tpu``, which stays the
reference it is tested against.  The layout mirrors the JAX package:

- ``mesh``          triangle meshes, the unit-square, periodic-square and
                    unit-disk generators and the C++ connectivity kernel
                    (built with g++ on first use)
- ``fem``           quadrature, Lagrange bases, space tabulations, ``Geom``
                    tensors and ``HDGDiscretisation``, CG spaces
- ``ops``           facet<->cell moves (slices and rolls on structured
                    meshes, index gathers on the disk), fields, forms,
                    projection, the RT element layer, the tracer, vorticity
- ``linalg``        condensation, GMRES, FGMRES and CG, GTMG, the tentative
                    operator and its Schwarz sweep, the monolithic stage
                    solve, small inverses
- ``models``        Taylor-Green, the double shear layer, Kelvin-Helmholtz
- ``timesteppers``  IMEX tableaus, HDG IMEX (projection or monolithic), HDG
                    implicit, DG implicit, conforming RT1 x DG0 implicit
- ``utils``         timers, checkpoints (the JAX package's file format), VTK
                    files and time series, the animation callback
- ``cli``           the command-line driver (``python -m
                    incompressibleeulerhdg_tpu_torch.cli.driver``)
- ``tools``         kernel A/B, plan sweeps and step profiles on the card;
                    the JAX driver as a same-machine reference
- ``kernels``       build and launch of the CUDA kernels in ``csrc/``
- ``convert``       JAX package objects -> port objects (for the tests)

The port imports nothing of the JAX package: the numpy modules it shares
with it (``mesh``, ``fem.quadrature``, ``fem.lagrange``, ``fem.spaces``,
``timesteppers.tableaus``, ``utils.logging``, ``utils.checkpoint``,
``utils.vtk``, ``utils.grid``) are its own copies, held equal to the originals by
tests/test_torch_shared.py.
"""

__version__ = "0.1.0"

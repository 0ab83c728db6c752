"""Slab-decomposed execution over ``torch.distributed`` ranks (``--n_devices``).

Counterpart of incompressibleeulerhdg_tpu/parallel/slab.py: ``comm`` (halo
rows and sums), ``slab`` (each rank's slab-local tables), ``launch`` (one
process per rank).
"""

"""Distributed execution over ``torch.distributed`` ranks (``--n_devices``).

Counterpart of incompressibleeulerhdg_tpu/parallel/slab.py and sharding.py:
``comm`` (halo rows, ghost entries and sums), ``slab`` (each rank's
slab-local tables), ``partition`` (each rank's cells, facets and ghost
plans on any mesh), ``launch`` (one process per rank).
"""

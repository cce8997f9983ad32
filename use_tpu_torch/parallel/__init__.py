"""Data-parallel training over the ranks of a torchrun launch and the
layout of its ranks (``mesh.py``), and tensor parallelism over the layout's
model axis (``sharding.py``): the port's counterpart of use_tpu/parallel."""

"""Data-parallel training over the ranks of a torchrun launch
(``mesh.py``), the port's counterpart of use_tpu/parallel."""

"""use_tpu_torch: the PyTorch / CUDA (NVIDIA H100) port of use_tpu.

A second package beside ``use_tpu``, with the same module names. It imports
torch, numpy, scipy and yaml, and nothing of JAX or of ``use_tpu``. Plain
tensor code is PyTorch; the kernels that ``use_tpu`` wrote in Pallas for the
TPU are hand-written CUDA C++ for Hopper (``csrc/``), built with nvcc at
first use and loaded with ctypes (``ops/cuda_build.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; a
CUDA request without a card raises.
"""

"""PyTorch/CUDA port of DeepI2P-TPU.

A second package beside the JAX reference ``deepi2p_tpu``: it imports
``torch`` and never JAX or the JAX package.  Plain tensor code is
PyTorch; each Pallas kernel of the JAX package is a CUDA kernel written
for Hopper (``csrc/``), built by :mod:`deepi2p_tpu_torch._build` and
launched by a wrapper that uses the kernel's plain PyTorch version only
for tensors on the CPU.
"""
from .device import resolve_device

__all__ = ["resolve_device"]

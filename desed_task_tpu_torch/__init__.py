"""PyTorch/CUDA port of desed_task_tpu for NVIDIA Hopper (H100).

The JAX package `desed_task_tpu` stays the reference; this package mirrors
its module names where a reader needs to find a counterpart. It imports
torch, numpy and scipy only. Every Pallas kernel on a ported path becomes a
hand-written CUDA kernel under `csrc/`, built with nvcc at first use
(`ops/_build.py`) and held against a plain PyTorch version kept beside it.

Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""

from .device import resolve_device

__all__ = ["resolve_device"]

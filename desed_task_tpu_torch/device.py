"""Device selection for the port's entry points, and the fp32 pin."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`cuda` unless the caller names another device.

    Raises when CUDA is asked for (explicitly or by default) and there is no
    card: an entry point never carries on silently on the CPU.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


@contextlib.contextmanager
def fp32_math():
    """TF32 off for cuDNN's convolutions and cuBLAS's products inside the
    block; the process's settings are restored on exit. PyTorch lets cuDNN
    take TF32 by default, so a module whose JAX counterpart computes in fp32
    (the TDCN, the embedders) runs its forward under this pin."""
    flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
    prev = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f, p in zip(flags, prev):
            f.allow_tf32 = p

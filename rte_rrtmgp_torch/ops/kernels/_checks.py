"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch


def takes_twin(t: torch.Tensor) -> bool:
    """True when the wrapper takes its plain PyTorch twin: ``t`` lies on the
    CPU, or it is float64 (the JAX package's dtype rule: its Pallas kernels
    run for float32 only and float64 stays on the accelerator through XLA).
    A float32 tensor on a card goes to the kernel or raises."""
    return t.device.type == "cpu" or t.dtype == torch.float64


def require(name: str, t: torch.Tensor, device: torch.device, dtype,
            shape=None, contiguous: bool = True) -> None:
    """Raise unless ``t`` is on ``device`` (a CUDA device), has ``dtype``,
    ``shape`` (when given) and, when asked, is contiguous."""
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype} "
                        "(the CUDA kernels are float32; float64 takes the plain twin)")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream

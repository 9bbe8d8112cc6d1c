"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch


def takes_twin(*ts) -> bool:
    """True when the wrapper takes its plain PyTorch twin: the first of its
    operands ``ts`` lies on the CPU, or one of them is float64 (the JAX
    package's dtype rule: its Pallas kernels run for float32 only and
    float64, or float32 mixed with float64, stays on the accelerator
    through XLA).  float32 operands on a card go to the kernel or raise.
    ``None`` operands are skipped."""
    return ts[0].device.type == "cpu" or any(
        t is not None and t.dtype == torch.float64 for t in ts)


def refuse_grad(name: str, *ts) -> None:
    """Raise where autograd would need a path back through kernel ``name``:
    grad mode is on and one of the (float32 CUDA) inputs ``ts`` requires
    grad.  The kernels have no backward, as the JAX package's Pallas kernels
    have no transpose rule; the plain twins, which float64 and the CPU take,
    differentiate."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in ts):
        raise RuntimeError(
            f"{name}: an input requires grad and the float32 CUDA kernel has "
            "no backward; differentiate in float64, whose plain twins carry "
            "the gradient, or call it under torch.no_grad()")


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
    """The current stream of ``device``.  A launch runs under
    ``torch.cuda.device(device)`` as well, so the kernel starts on its
    tensors' device whatever the current device is."""
    return torch.cuda.current_stream(device).cuda_stream

"""Device selection shared by the port's entry points, and the full-f32
scope of the cuDNN convolutions."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device; raises when CUDA is absent.

    Any other value is taken as given (``"cpu"`` runs the plain PyTorch
    path).  A bare ``"cuda"`` is pinned to the current device index so it
    compares equal to the device of the tensors placed on it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@contextlib.contextmanager
def full_f32():
    """cuDNN convolutions in full f32 (TF32, cuDNN's default, keeps about
    three digits) and with deterministic algorithms, so that a training run
    repeats itself exactly.  The flags are read when a convolution runs,
    and autograd runs a convolution's backward inside ``backward()``: wrap
    that call too."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = prev

"""What the stand-alone kernels' wrappers share: where an input goes,
the checks before a launch, and the launch's error code."""
from __future__ import annotations

import torch


def as_tensor(x, dtype: torch.dtype | None, device=None) -> torch.Tensor:
    """``x`` as a tensor of ``dtype`` (None keeps a tensor's own dtype).
    A tensor stays on its device unless ``device`` is given; anything
    else (numpy arrays, lists) goes to ``device``, by default the card."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=dtype or x.dtype)
    return torch.as_tensor(x, dtype=dtype, device=device or "cuda")


def check_device(dev: torch.device, name: str) -> None:
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")


def check_input(t: torch.Tensor, dtype: torch.dtype, shape: tuple,
                dev: torch.device, name: str) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    on ``dev`` — what the kernel reads through a raw pointer."""
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{name} input: want {dtype} {shape} contiguous on {dev}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}")


def stream(dev: torch.device) -> int:
    """PyTorch's current CUDA stream on ``dev``, as the C entry points
    take it."""
    return torch.cuda.current_stream(dev).cuda_stream


def raise_on(err: int, name: str) -> None:
    """A launch returns ``cudaGetLastError()``; raise if it is not 0."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")

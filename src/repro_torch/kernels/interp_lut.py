"""Stand-alone LUT interpolation unit (IU) kernel: element-wise
piecewise-linear interpolation of a float32 tensor on a small table.

The kernel (``csrc/interp_lut.cu``, CUDA C++ for ``sm_90a``) replaces the
JAX package's Pallas kernel ``repro.kernels.interp_lut._interp_kernel``
(launched by ``interp_pallas``).  Its plain PyTorch version is
:func:`repro_torch.kernels.ref.interp_ref`, and the two are equal bit
for bit: each stage is one separately rounded float32 op in both.

It is CUDA C++ rather than Triton so that one build route serves every
kernel of the port, and because the intrinsics pin each rounding where
Triton would need its fp fusion switched off to stay bitwise.

:func:`interp_lut` takes the plain version only for tensors that lie on
the CPU; on a CUDA tensor it launches the kernel or raises.
``interp_lut.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _common
from repro_torch.kernels import ref as ref_lib

# largest table the kernel stages in shared memory (segments)
MAX_SEGMENTS = 8192


@functools.cache
def _entry():
    """The kernel library's C entry point, built at first use."""
    from repro_torch.kernels import _build

    fn = _build.load("interp_lut").interp_lut_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, ctypes.c_longlong, i, f, f, i, p]
    fn.restype = i
    return fn


def _launch(x: torch.Tensor, table: torch.Tensor, lo: float, hi: float,
            block: int = 256) -> torch.Tensor:
    """One launch of the CUDA kernel on PyTorch's current stream."""
    n_seg = int(table.shape[-1]) - 1
    y = torch.empty_like(x)
    err = _entry()(x.data_ptr(), table.data_ptr(), y.data_ptr(), x.numel(),
                   n_seg, float(lo), float(n_seg / (hi - lo)), block,
                   _common.stream(x.device))
    _common.raise_on(err, "interp_lut")
    interp_lut.launches += 1
    return y


def interp_lut(x, table, *, lo: float, hi: float,
               device=None) -> torch.Tensor:
    """Interpolate the ``(T+1,)`` float32 node table over [lo, hi] at every
    element of the float32 tensor ``x`` (any shape; the TPU kernel took
    (B, N) tiles); inputs are clamped to the range.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    Non-tensor inputs go to ``device``, by default the card."""
    x = _common.as_tensor(x, torch.float32, device)
    dev = x.device
    _common.check_device(dev, "interp_lut")
    table = _common.as_tensor(table, torch.float32, dev)
    n_seg = int(table.shape[-1]) - 1
    if table.dim() != 1 or not 1 <= n_seg <= MAX_SEGMENTS:
        raise ValueError(f"interp_lut takes a 1-D table of 2 to "
                         f"{MAX_SEGMENTS + 1} nodes, got {tuple(table.shape)}")
    if not hi > lo:
        raise ValueError(f"interp_lut needs hi > lo, got [{lo}, {hi}]")
    if dev.type == "cpu":
        return ref_lib.interp_ref(x, table, lo, hi)
    return _launch(x.contiguous(), table.contiguous(), lo, hi)


interp_lut.launches = 0

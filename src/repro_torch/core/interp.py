"""LUT-based interpolation unit (paper §II-B, C2) — torch twin.

The AIA IU evaluates ``exp``, ``log`` … by piecewise linear
interpolation on a small LUT held in registers:

    y = LUT[idx] + frac * (LUT[idx+1] - LUT[idx])

:func:`masked_exp_weights` is the shared distribution-generation tail of
every Gibbs family (label mask → max-subtract → LUT-exp → fixed-point
floor).  It is the plain PyTorch version of the first half of the fused
sweep kernel (``kernels/csrc/fused_sweep.cu``), and it matches the JAX
package's function bit for bit on the IU path: every float stage is one
separately rounded float32 op — ``(x - lo) * scale``, clip, truncate,
``frac``, ``y0 + frac * (y1 - y0)``, ``floor(y * (2**k - 1))`` — with no
fused multiply-add, and eager torch ops never fuse.  The ``use_iu=False``
path calls ``torch.exp``, which differs from XLA's ``exp`` in the last
ulp on some inputs, so that path is held to the reference within ±1
weight, not bitwise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch


@dataclass(frozen=True)
class InterpTable:
    """Piecewise-linear LUT over [lo, hi] with 2**m segments."""

    table: torch.Tensor   # (2**m + 1,) float32 node values
    lo: float
    hi: float
    m: int                # log2 #segments

    @staticmethod
    def build(fn: Callable, lo: float, hi: float, m: int = 8) -> "InterpTable":
        # nodes evaluated in float64, stored as float32 (as the reference)
        xs = np.linspace(lo, hi, (1 << m) + 1, dtype=np.float64)
        tab = torch.from_numpy(np.asarray(fn(xs), dtype=np.float32))
        return InterpTable(table=tab, lo=float(lo), hi=float(hi), m=m)

    @property
    def scale(self) -> float:
        """Segments per unit input, ``2**m / (hi - lo)`` (a Python float,
        rounded to float32 where it meets float32 data)."""
        return (1 << self.m) / (self.hi - self.lo)

    def to(self, device) -> "InterpTable":
        return InterpTable(self.table.to(device), self.lo, self.hi, self.m)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Interpolate fn(x); inputs are clamped to [lo, hi]."""
        x = torch.as_tensor(x, dtype=torch.float32)
        n = 1 << self.m
        t = torch.clamp((x - self.lo) * self.scale, 0.0, float(n))
        idx = torch.clamp_max(t.to(torch.int64), n - 1)   # "IU.address"
        frac = t - idx.to(torch.float32)                   # "offset"
        tab = self.table.to(x.device)
        y0 = tab[idx]
        y1 = tab[torch.clamp_max(idx + 1, n)]
        return y0 + frac * (y1 - y0)

    def max_abs_error(self, fn: Callable, probe: int = 65536) -> float:
        xs = np.linspace(self.lo, self.hi, probe).astype(np.float32)
        exact = np.asarray(fn(xs.astype(np.float64)))
        approx = self(torch.from_numpy(xs)).numpy()
        return float(np.max(np.abs(exact - approx)))


# exp over negative energies: exp(x) for x in [-16, 0] covers weights down
# to ~1e-7 — below quantization resolution for k<=24.
def exp_table(m: int = 10) -> InterpTable:
    return InterpTable.build(np.exp, -16.0, 0.0, m)


# Labels at or beyond a lane's cardinality are masked to this log-weight
# before the max-subtract: far below any reachable real energy and deep
# under the exp-LUT's lo clamp, so the masked weight quantizes to 0 for
# every k <= 23 (exp(-16) * (2**23 - 1) < 1).
MASK_NEG = -240.0


def masked_exp_weights(
    logw: torch.Tensor,
    card: torch.Tensor,
    k: int,
    *,
    use_iu: bool = True,
    table: "InterpTable | None" = None,
    mask_value: float = MASK_NEG,
) -> torch.Tensor:
    """Shared Gibbs distribution-generation tail: log-weights -> KY weights.

    ``w = floor(exp(logw - max logw) * (2**k - 1))`` with labels
    ``>= card`` first masked to ``mask_value``, and ``exp`` evaluated
    through the IU LUT when ``use_iu``.  ``logw`` is (..., L) float32;
    ``card`` broadcasts against the batch axes.  Returns int32 weights.
    """
    logw = torch.as_tensor(logw, dtype=torch.float32)
    card = torch.as_tensor(card, device=logw.device)
    ls = torch.arange(logw.shape[-1], device=logw.device)
    logw = torch.where(ls < card[..., None], logw,
                       torch.tensor(mask_value, dtype=torch.float32,
                                    device=logw.device))
    z = logw - torch.amax(logw, dim=-1, keepdim=True)
    if use_iu:
        y = (table or _EXP_DEFAULT)(z)
    else:
        y = torch.exp(z)
    return torch.floor(y * (2.0 ** k - 1.0)).to(torch.int32)


_EXP_DEFAULT = exp_table()

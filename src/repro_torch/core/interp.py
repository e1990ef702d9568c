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


def interpolate(x: torch.Tensor, table: torch.Tensor, lo: float,
                hi: float) -> torch.Tensor:
    """Piecewise-linear interpolation of float32 ``x`` on the ``(T+1,)``
    node table over [lo, hi], inputs clamped to the range — the IU, and
    the plain version of the IU kernel (``kernels/csrc/interp_lut.cu``).
    ``lo`` and ``T / (hi - lo)`` round to float32 where they meet the
    data; every stage is one rounded float32 op."""
    x = torch.as_tensor(x, dtype=torch.float32)
    table = torch.as_tensor(table, dtype=torch.float32, device=x.device)
    n_seg = int(table.shape[-1]) - 1
    t = torch.clamp((x - lo) * (n_seg / (hi - lo)), 0.0, float(n_seg))
    idx = torch.clamp_max(t.to(torch.int64), n_seg - 1)   # "IU.address"
    frac = t - idx.to(torch.float32)                       # "offset"
    y0 = table[idx]
    y1 = table[idx + 1]
    return y0 + frac * (y1 - y0)


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
        return interpolate(x, self.table, self.lo, self.hi)

    def max_abs_error(self, fn: Callable, probe: int = 65536) -> float:
        xs = np.linspace(self.lo, self.hi, probe).astype(np.float32)
        exact = np.asarray(fn(xs.astype(np.float64)))
        approx = self(torch.from_numpy(xs)).numpy()
        return float(np.max(np.abs(exact - approx)))


# exp over negative energies: exp(x) for x in [-16, 0] covers weights down
# to ~1e-7 — below quantization resolution for k<=24.
def exp_table(m: int = 10) -> InterpTable:
    return InterpTable.build(np.exp, -16.0, 0.0, m)


def log_table(m: int = 10) -> InterpTable:
    """LUT over the mantissa range [1, 2) — see :func:`iu_log`."""
    return InterpTable.build(np.log, 1.0, 2.0, m)


def iu_log(x: torch.Tensor, table: InterpTable | None = None) -> torch.Tensor:
    """log(x) via mantissa/exponent split + PWL LUT (the HW-idiomatic form).

    ``x = mant * 2**e`` with ``mant in [0.5, 1)`` (``torch.frexp`` and
    ``jnp.frexp`` agree on that convention); ``log x = LUT(2 * mant) +
    (e - 1) * ln2``.  Inputs are clamped to at least 1e-30.
    """
    table = table or _LOG_DEFAULT
    x = torch.as_tensor(x, dtype=torch.float32)
    mant, e = torch.frexp(torch.clamp_min(x, 1e-30))
    ln2 = float(np.float32(np.log(2.0)))
    return table(mant * 2.0) + (e - 1).to(torch.float32) * ln2


def sigmoid_table(m: int = 10) -> InterpTable:
    return InterpTable.build(lambda x: 1.0 / (1.0 + np.exp(-x)), -8.0, 8.0, m)


def softplus_table(m: int = 10) -> InterpTable:
    return InterpTable.build(lambda x: np.log1p(np.exp(x)), -8.0, 8.0, m)


def iu_exp_weights(energies: torch.Tensor, k: int,
                   table: InterpTable | None = None) -> torch.Tensor:
    """Energies -> non-normalized KY weights through the IU:
    ``floor(iu_exp(e - max(e)) * (2**k - 1))`` — max-subtract (no
    sum-normalization), LUT-exp, fixed-point floor.  Returns int32."""
    table = table or _EXP_DEFAULT
    e = torch.as_tensor(energies, dtype=torch.float32)
    z = e - torch.amax(e, dim=-1, keepdim=True)
    return torch.floor(table(z) * (2.0 ** k - 1.0)).to(torch.int32)


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
_LOG_DEFAULT = log_table()

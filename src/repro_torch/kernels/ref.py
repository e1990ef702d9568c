"""Plain PyTorch versions of the stand-alone kernels (bit-exact
semantics), torch twin of ``repro.kernels.ref``.

``ky_ref`` mirrors the KY kernel's **global** bit cursor: every lane
reads bit ``it`` of its own word stream at iteration ``it``.  That uses
other stream positions than ``core.ky``'s per-lane cursor, so the two
are comparable in distribution only.  ``interp_ref`` is the IU kernel's
element-wise LUT interpolation, one separately rounded float32 op per
stage (``core.interp.interpolate``, which ``InterpTable`` calls too).
``mha_ref`` is the dense-softmax yardstick for flash attention.
Each runs on the device of its inputs.
"""
from __future__ import annotations

import torch

from repro_torch.core.fixedpoint import ceil_log2
from repro_torch.core.interp import interpolate as interp_ref  # noqa: F401


def ky_prep(weights: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The (klvl, rej) columns the KY kernel consumes, from (B, n)
    weights: DDG depth ``K = max(ceil_log2(total), 1)`` and rejection pad
    ``2**K - total``, each (B, 1) int32."""
    w = torch.as_tensor(weights).to(torch.int64)
    total = torch.clamp_min(w.sum(dim=-1), 1)
    klvl = torch.clamp_min(ceil_log2(total).to(torch.int64), 1)
    rej = (1 << klvl) - total
    return (klvl[:, None].to(torch.int32),
            rej[:, None].to(torch.int32))


def ky_ref(weights: torch.Tensor, words: torch.Tensor,
           budget: int | None = None):
    """KY walk with the kernel's semantics on (B, n) int32 weights and
    (B, W) int32 bit words.  Returns (sample, bits, ok), each (B, 1):
    int32, int32, bool."""
    klvl, rej = ky_prep(weights)
    budget = budget if budget is not None else int(words.shape[-1]) * 32
    return ky_walk_global(weights, words, klvl, rej, budget)


def ky_walk_global(weights: torch.Tensor, words: torch.Tensor,
                   klvl: torch.Tensor, rej: torch.Tensor, budget: int):
    """The walk of :func:`ky_ref` on given (B, 1) ``klvl``/``rej``
    columns: the plain version of the KY kernel, on the same inputs.

    The lock-step loop stops once every lane is done; a finished lane's
    state never changes, so that equals running the whole budget."""
    w = torch.as_tensor(weights).to(torch.int64)
    b, n = w.shape
    dev = w.device
    klvl, rej = klvl.to(torch.int64), rej.to(torch.int64)
    words = words.to(torch.int64)

    total = w.sum(dim=1, keepdim=True)
    amax = torch.argmax(w, dim=1, keepdim=True)
    done = w.amax(dim=1, keepdim=True) == total   # deterministic-row bypass
    z = torch.zeros((b, 1), dtype=torch.int64, device=dev)
    d, c, bits = z, z, z
    res = torch.where(done, amax, 0)
    for it in range(budget):
        if bool(done.all()):
            break
        active = ~done
        bit = (words[:, it // 32:it // 32 + 1] >> (it % 32)) & 1
        d2 = 2 * d + (1 - bit)
        shift = klvl - 1 - c
        sh = torch.clamp_min(shift, 0)
        col = torch.where(shift >= 0, (w >> sh) & 1, 0)
        rcol = torch.where(shift >= 0, (rej >> sh) & 1, 0)
        cum = torch.cumsum(col, dim=1)
        colsum = cum[:, -1:] + rcol
        hit = d2 < colsum
        ge = cum >= d2 + 1
        has_real = ge.any(dim=1, keepdim=True)
        sel = torch.argmax(ge.to(torch.int32), dim=1, keepdim=True)
        finish = hit & has_real & active
        restart = ((hit & ~has_real) | (~hit & (c + 1 >= klvl))) & active
        res = torch.where(finish, sel, res)
        done = done | finish
        d = torch.where(restart, 0, torch.where(hit, d, d2 - colsum))
        c = torch.where(restart, 0, torch.where(hit, c, c + 1))
        bits = bits + active
    # fallback (budget exhausted): the argmax outcome
    sample = torch.where(done, res, amax)
    return sample.to(torch.int32), bits.to(torch.int32), done


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True) -> torch.Tensor:
    """Dense-softmax attention on (BH, S, dh): scores from inputs upcast
    to float32 (full float32 matmuls: TF32 is switched off inside), the
    causal mask at -1e30, ``p`` cast to ``v.dtype`` before the PV
    product, which accumulates in float32; returns ``q.dtype``."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        s = torch.einsum("bqd,bkd->bqk", q.float(), k.float())
        s = s * q.shape[-1] ** -0.5
        if causal:
            n = q.shape[1]
            mask = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
            s = torch.where(mask[None], s, -1e30)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float())
    finally:
        torch.set_float32_matmul_precision(prev)
    return o.to(q.dtype)

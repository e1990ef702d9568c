"""Mixture-of-Experts with Switch/T5X-style capacity dispatch.

Torch twin of ``repro.models.moe``: top-k routing with a static
per-group capacity (groups are sequences); overflow tokens are dropped
and their residual stream passes through unchanged.  Expert parallelism
is not ported (one device holds every expert).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamModule, act_fn, normal_


class MoE(ParamModule):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__(cfg, device)
        d, e, ff = cfg.d_model, cfg.n_experts, cfg.expert_ff
        self.param("router", d, e)
        self.param("wi", e, d, ff)
        self.param("wo", e, ff, d)
        if cfg.act == "swiglu":
            self.param("wg", e, d, ff)

    def reset_parameters(self, gen: torch.Generator) -> None:
        _, d, ff = self.wi.shape
        normal_(self.router, gen, d ** -0.5)
        normal_(self.wi, gen, d ** -0.5)
        normal_(self.wo, gen, ff ** -0.5)
        if hasattr(self, "wg"):
            normal_(self.wg, gen, d ** -0.5)


def moe_capacity(cfg: ModelConfig, group_size: int) -> int:
    c = int(cfg.capacity_factor * group_size * cfg.top_k / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8 for layout friendliness


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, ties broken
    towards the lower index (``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def apply_moe(moe: MoE, cfg: ModelConfig, x: torch.Tensor
              ) -> tuple[torch.Tensor, dict]:
    """x: (B, S, D) -> (out, aux) with load-balance/z losses in aux."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = moe_capacity(cfg, s)
    dt = x.dtype
    f32 = torch.float32

    logits = (x @ moe.w("router", dt)).float()
    probs = torch.softmax(logits, dim=-1)

    # --- top-k choice + position within expert (per group = per sequence)
    gate_vals, expert_ids = _top_k(probs, k)                 # (B, S, k)
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)  # renorm top-k
    onehot = F.one_hot(expert_ids, e).to(f32)                 # (B,S,k,E)
    # priority: earlier tokens (and lower k-slot) first, per sequence
    flat = onehot.reshape(b, s * k, e)
    pos_in_expert = (torch.cumsum(flat, dim=1) - flat).reshape(b, s, k, e)
    within_cap = pos_in_expert < cap
    pos = torch.sum(pos_in_expert * onehot, dim=-1)          # (B, S, k)
    keep = torch.sum(within_cap * onehot, dim=-1) > 0        # (B, S, k)

    # --- dispatch/combine tensors --------------------------------------
    # jax.nn.one_hot gives an all-zero row for an index past ``cap``
    pos_oh = (pos[..., None] == torch.arange(cap, device=x.device)).to(f32)
    disp = torch.einsum("bske,bskc->bsec", onehot * keep[..., None], pos_oh)
    comb = torch.einsum("bske,bskc,bsk->bsec",
                        onehot, pos_oh, gate_vals * keep)

    xe = torch.einsum("bsd,bsec->becd", x, disp.to(dt))      # (B, E, C, D)
    h = torch.einsum("becd,edf->becf", xe, moe.w("wi", dt))
    if "wg" in moe._parameters:
        g = torch.einsum("becd,edf->becf", xe, moe.w("wg", dt))
        h = act_fn(cfg.act, h, g)
    else:
        h = act_fn(cfg.act, h)
    ye = torch.einsum("becf,efd->becd", h, moe.w("wo", dt))
    y = torch.einsum("becd,bsec->bsd", ye, comb.to(dt))

    # --- aux losses (Switch §2.2) ---------------------------------------
    me = torch.mean(onehot[:, :, 0, :], dim=(0, 1))          # router top-1 frac
    ce = torch.mean(probs, dim=(0, 1))
    aux = {
        "load_balance": e * torch.sum(me * ce),
        "router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        "drop_frac": 1.0 - torch.mean(keep.to(f32)),
    }
    return y, aux

"""Mixture-of-Experts with Switch/T5X-style capacity dispatch.

Torch twin of ``repro.models.moe``: top-k routing with a static
per-group capacity (groups are sequences); overflow tokens are dropped
and their residual stream passes through unchanged.  ``aux`` also
carries the router statistics as sums (``me_sum``, ``ce_sum``,
``z_sum``, ``n``), so a batch split over "data" gets the load-balance
loss of the whole batch (:func:`moe_loss`).

On a mesh (:mod:`repro_torch.sharding.partition`) the router, top-k,
capacity, dispatch and combine run on each batch shard's home device,
as on one device (the router is replicated by spec).  The experts'
products take the layout ``param_specs`` gives ``wi``/``wg``/``wo``
(:func:`_experts`): expert parallel where "model" splits the experts
(``E % model == 0``), column parallel inside each expert where it splits
the expert ffn, whole at home where it splits neither.  The reference
lets XLA insert the token all-to-all under those specs; here the
dispatched blocks move by counted copies ("reshard").
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamModule, act_fn, normal_
from repro_torch.sharding import partition


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
    ye = _experts(moe, cfg, xe)
    y = torch.einsum("becd,bsec->bsd", ye, comb.to(dt))

    # --- aux losses (Switch §2.2) ---------------------------------------
    me = torch.mean(onehot[:, :, 0, :], dim=(0, 1))          # router top-1 frac
    ce = torch.mean(probs, dim=(0, 1))
    z2 = torch.logsumexp(logits, dim=-1) ** 2
    aux = {
        "load_balance": e * torch.sum(me * ce),
        "router_z": torch.mean(z2),
        "drop_frac": 1.0 - torch.mean(keep.to(f32)),
        "me_sum": torch.sum(onehot[:, :, 0, :], dim=(0, 1)),
        "ce_sum": torch.sum(probs, dim=(0, 1)),
        "z_sum": torch.sum(z2),
        "n": b * s,
    }
    return y, aux


def _expert_ffn(moe: MoE, cfg: ModelConfig, xe: torch.Tensor,
                tp: int | None) -> torch.Tensor:
    """The experts' hidden activations on ``xe`` (B, E', C, D), from the
    ``wi``/``wg`` of "model" piece ``tp`` (the whole leaves with
    ``None``)."""
    dt = xe.dtype
    h = torch.einsum("becd,edf->becf", xe, moe.w("wi", dt, tp))
    if moe.has("wg"):
        g = torch.einsum("becd,edf->becf", xe, moe.w("wg", dt, tp))
        return act_fn(cfg.act, h, g)
    return act_fn(cfg.act, h)


def _experts(moe: MoE, cfg: ModelConfig, xe: torch.Tensor) -> torch.Tensor:
    """The dispatched tokens ``xe`` (B, E, C, D) through their experts,
    on ``xe``'s device.  Where "model" splits the experts, "model" device
    j gets its experts' block of ``xe``, computes it on its own pieces of
    ``wi``/``wg``/``wo``, and the blocks come home in expert order.
    Where it splits the expert ffn of ``wi``/``wg``, they are column
    parallel: every "model" device gets ``xe`` and computes its block of
    the hidden activations, and the blocks are brought home and joined;
    ``wo`` is then applied whole at home, since the specs never split
    its ffn (the rule for a 3-dim ``wo`` tries the experts alone)."""
    dt = xe.dtype
    sh = moe.leaf("wi")
    devs = partition.tp_devices(sh)
    if devs is None:
        return torch.einsum("becf,efd->becd", _expert_ffn(moe, cfg, xe, None),
                            moe.w("wo", dt))
    pos = partition.tp_positions()
    if sh.model_dim() == 0:                     # experts over "model"
        el = xe.shape[1] // len(devs)
        parts = []
        for j, d in enumerate(devs):
            xj = partition.move(xe[:, j * el:(j + 1) * el], d, pos[0],
                                pos[j])
            parts.append(torch.einsum("becf,efd->becd", _expert_ffn(
                moe, cfg, xj, j), moe.w("wo", dt, j)))
        return torch.cat(partition.to_home(parts, xe.device), dim=1)
    hs = [_expert_ffn(moe, cfg, xj, j) for j, xj in enumerate(
        partition.broadcast(xe, devs, pos, pos[0]))]
    h = torch.cat(partition.to_home(hs, xe.device), dim=-1)
    return torch.einsum("becf,efd->becd", h, moe.w("wo", dt))


def moe_loss(auxes: list[dict], device) -> torch.Tensor:
    """One layer's router loss, 0.01 load balance + 0.001 router z, from
    the aux of each batch shard: one shard's own means, or the
    statistics of every shard summed in order on ``device``."""
    if len(auxes) == 1:
        a = auxes[0]
        return 0.01 * a["load_balance"] + 0.001 * a["router_z"]
    n = sum(a["n"] for a in auxes)
    tot = {k: None for k in ("me_sum", "ce_sum", "z_sum")}
    for a in auxes:
        for k in tot:
            t = a[k].to(device)
            tot[k] = t if tot[k] is None else tot[k] + t
    e = tot["me_sum"].shape[0]
    lb = e * torch.sum(tot["me_sum"] / n * (tot["ce_sum"] / n))
    return 0.01 * lb + 0.001 * (tot["z_sum"] / n)

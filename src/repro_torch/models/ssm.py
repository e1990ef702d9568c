"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060].

Torch twin of ``repro.models.ssm``.  Train/prefill use the chunked SSD
algorithm (quadratic form within a chunk, a linear recurrence across
chunks, here a loop); decode is the O(1) recurrent update.  Products the
reference accumulates in float32 (``preferred_element_type``) take
float32 operands here.

Layout: x is split into H heads of P dims (d_inner = H·P); B/C live in G
groups of N state dims.  A is a per-head negative scalar, dt a per-head
softplus rate.

On a mesh (:mod:`repro_torch.sharding.partition`) the projections take
the layout ``param_specs`` gives them.  Where "model" splits the fused
``in_proj`` (on Z, in equal blocks that cut across the z/x/B/C/dt
segments) or a split projection, it is column parallel: the input goes
to the "model" devices, each computes its block, and the blocks are
brought home and joined (:func:`_in_projections`).  The conv, the SSD
scan and the gate then run whole on the home device.  ``out_proj``
split on its rows is row parallel (:func:`_out_projection`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamModule, normal_, repeat_heads
from repro_torch.sharding import partition


class SSM(ParamModule):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__(cfg, device)
        d = cfg.d_model
        di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.n_ssm_heads
        conv_dim = di + 2 * g * n
        self.param("conv_w", cfg.ssm_conv, conv_dim)
        self.param("conv_b", conv_dim)
        self.param("a_log", h)
        self.param("dt_bias", h)
        self.param("d_skip", h)
        self.param("out_proj", di, d)
        if cfg.ssm_split_proj:
            # per-stream projections
            self.param("z_proj", d, di)
            self.param("x_proj", d, di)
            self.param("b_proj", d, g * n)
            self.param("c_proj", d, g * n)
            self.param("dt_proj", d, h)
        else:
            # fused projection: z (gate), x, B, C, dt
            self.param("in_proj", d, 2 * di + 2 * g * n + h)

    def reset_parameters(self, gen: torch.Generator) -> None:
        k = self.conv_w.shape[0]
        di, d = self.out_proj.shape
        h = self.a_log.shape[0]
        normal_(self.conv_w, gen, k ** -0.5)
        self.conv_b.zero_()
        self.a_log.copy_(torch.log(torch.linspace(1.0, 16.0, h)))
        # softplus(dt_bias) ~ [0.001, 0.1] (mamba2 init): softplus^-1(0.05)
        self.dt_bias.fill_(-3.0)
        self.d_skip.fill_(1.0)
        normal_(self.out_proj, gen, di ** -0.5)
        for name in ("in_proj", "z_proj", "x_proj", "b_proj", "c_proj",
                     "dt_proj"):
            if name in self._parameters:
                normal_(getattr(self, name), gen, d ** -0.5)


def _causal_conv(xbc, w, b, state=None):
    """Depthwise causal conv, kernel K. state: (B, K-1, C) carry for decode."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros_like(xbc[:, : k - 1])
        xp = torch.cat([pad, xbc], dim=1)
    else:
        xp = torch.cat([state.to(xbc.dtype), xbc], dim=1)
    out = sum(xp[:, i: xp.shape[1] - (k - 1 - i)] * w[i] for i in range(k))
    new_state = xp[:, -(k - 1):] if k > 1 else None
    return F.silu(out + b), new_state


def ssd_chunked(x, dt, a, b_mat, c_mat, *, chunk: int):
    """Chunked SSD scan.

    x: (B, S, H, P); dt: (B, S, H) (post-softplus); a: (H,) negative;
    b_mat/c_mat: (B, S, G, N).  Returns y: (B, S, H, P).
    """
    bs, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    nc = s // chunk
    assert s % chunk == 0
    rep = h // g
    f32 = torch.float32

    xc = x.reshape(bs, nc, chunk, h, p)
    dtc = dt.reshape(bs, nc, chunk, h)
    bc = b_mat.reshape(bs, nc, chunk, g, n)
    cc = c_mat.reshape(bs, nc, chunk, g, n)

    da = dtc * a  # (B, nc, Q, H) negative increments
    cum = torch.cumsum(da, dim=2)                      # running log-decay
    seg_total = cum[:, :, -1]                          # (B, nc, H)

    # ---- intra-chunk (quadratic) ---------------------------------------
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,Q,Q,H) i-j
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))[None, None, :, :, None]
    # mask BEFORE exp: exp of the masked (i<j, positive) entries overflows
    decay = torch.exp(torch.where(causal, li, -60.0)) * causal
    cb = torch.einsum("bzqgn,bzsgn->bzqsg", cc.to(f32), bc.to(f32))
    cb = repeat_heads(cb, rep, -1)                       # groups -> heads
    w_ij = cb * decay * dtc[:, :, None, :, :]            # (B,nc,Q,S,H)
    y = torch.einsum("bzqsh,bzshp->bzqhp", w_ij.to(x.dtype).to(f32),
                     xc.to(f32))

    # ---- chunk states + inter-chunk recurrence --------------------------
    dec_to_end = torch.exp(seg_total[:, :, None, :] - cum)   # (B,nc,Q,H)
    xb = xc * (dtc * dec_to_end)[..., None]                  # weight each step
    bh = repeat_heads(bc, rep, 3)                            # (B,nc,Q,H,N)
    states = torch.einsum("bzqhn,bzqhp->bzhnp", bh.to(x.dtype).to(f32),
                          xb.to(f32))                        # (B,nc,H,N,P)

    h_run = torch.zeros((bs, h, n, p), dtype=f32, device=x.device)
    h_prevs = []                                 # state before each chunk
    for z in range(nc):
        h_prevs.append(h_run)
        h_run = h_run * torch.exp(seg_total[:, z])[..., None, None] + states[:, z]
    h_prevs = torch.stack(h_prevs, dim=1)                    # (B,nc,H,N,P)

    # ---- contribution of carried state to each position -----------------
    ch = repeat_heads(cc, rep, 3)                            # (B,nc,Q,H,N)
    dec_from_start = torch.exp(cum)                          # (B,nc,Q,H)
    y_inter = torch.einsum("bzqhn,bzhnp->bzqhp", ch.to(x.dtype).to(f32),
                           h_prevs.to(x.dtype).to(f32))
    y = y + y_inter * dec_from_start[..., None]
    return y.reshape(bs, s, h, p).to(x.dtype)


def apply_ssm(
    ssm: SSM,
    cfg: ModelConfig,
    u: torch.Tensor,               # (B, S, D)
    *,
    state: dict | None = None,     # decode: {"h": (B,H,N,P), "conv": (B,K-1,C)}
) -> tuple[torch.Tensor, dict | None]:
    di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.n_ssm_heads
    p = di // h
    bsz, s, _ = u.shape
    dt_ = u.dtype

    if ssm.has("in_proj"):
        zxbcdt, = _in_projections(ssm, ("in_proj",), u)
        z = zxbcdt[..., :di]
        xbc = zxbcdt[..., di: 2 * di + 2 * g * n]
        dt_raw = zxbcdt[..., 2 * di + 2 * g * n:]
    else:  # split projections (ssm_split_proj)
        z, xp, bp, cp, dt_raw = _in_projections(
            ssm, ("z_proj", "x_proj", "b_proj", "c_proj", "dt_proj"), u)
        xbc = torch.cat([xp, bp, cp], dim=-1)
    dt = F.softplus(dt_raw.float() + ssm.p("dt_bias"))
    a = -torch.exp(ssm.p("a_log"))                       # (H,) negative

    conv_state = state["conv"] if state is not None else None
    xbc, new_conv = _causal_conv(
        xbc, ssm.w("conv_w", dt_), ssm.w("conv_b", dt_), conv_state)
    x = xbc[..., :di].reshape(bsz, s, h, p)
    b_mat = xbc[..., di: di + g * n].reshape(bsz, s, g, n)
    c_mat = xbc[..., di + g * n:].reshape(bsz, s, g, n)

    new_state = None
    if state is not None:  # ---- O(1) decode update ------------------------
        assert s == 1
        f32 = torch.float32
        h_prev = state["h"]                              # (B,H,N,P) f32
        dt1 = dt[:, 0]                                   # (B,H)
        dec = torch.exp(dt1 * a[None])                   # (B,H)
        bh = repeat_heads(b_mat[:, 0], h // g, 1)        # (B,H,N)
        xh = x[:, 0] * dt1[..., None]                    # (B,H,P)
        h_new = h_prev * dec[..., None, None] + torch.einsum(
            "bhn,bhp->bhnp", bh.to(f32), xh.to(f32))
        ch = repeat_heads(c_mat[:, 0], h // g, 1)        # (B,H,N)
        y = torch.einsum("bhn,bhnp->bhp", ch.to(f32), h_new)
        y = y[:, None].to(dt_).reshape(bsz, 1, h, p)     # (B,1,H,P)
        new_state = {"h": h_new, "conv": new_conv}
    else:
        y = ssd_chunked(x, dt, a, b_mat, c_mat, chunk=min(cfg.ssm_chunk, s))

    y = y + x * ssm.w("d_skip", dt_)[None, None, :, None]
    y = y.reshape(bsz, s, di) * F.silu(z)
    return _out_projection(ssm, y), new_state


def _in_projections(ssm: SSM, names, u: torch.Tensor) -> list:
    """``u @ w`` for each projection of ``names``, whole on ``u``'s
    device.  A projection the spec splits over "model" is column
    parallel: ``u`` goes to the "model" devices (once for all of them),
    each computes its block of columns, and the blocks are brought home
    and joined in order."""
    dt = u.dtype
    devs = [partition.tp_devices(ssm.leaf(n)) for n in names]
    split = next((d for d in devs if d is not None), None)
    if split is not None:
        pos = partition.tp_positions()
        us = partition.broadcast(u, split, pos, pos[0])
    out = []
    for name, d in zip(names, devs):
        if d is None:
            out.append(u @ ssm.w(name, dt))
            continue
        parts = [uj @ ssm.w(name, dt, j) for j, uj in enumerate(us)]
        out.append(torch.cat(partition.to_home(parts, u.device), dim=-1))
    return out


def _out_projection(ssm: SSM, y: torch.Tensor) -> torch.Tensor:
    """``y @ out_proj`` on ``y``'s device; row parallel where the spec
    splits ``out_proj``'s rows over "model": piece j of ``y`` goes to
    "model" device j, and the partial products are added home in device
    order."""
    dt = y.dtype
    devs = partition.tp_devices(ssm.leaf("out_proj"))
    if devs is None:
        return y @ ssm.w("out_proj", dt)
    pos = partition.tp_positions()
    parts = [partition.move(yj, d, pos[0], pos[j]) @ ssm.w("out_proj", dt, j)
             for j, (d, yj) in enumerate(zip(devs, y.chunk(len(devs), -1)))]
    return partition.reduce_sum(parts, y.device, pos, pos[0])


def init_ssm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.n_ssm_heads
    p = di // h
    conv_dim = di + 2 * g * n
    return {
        "h": torch.zeros((batch, h, n, p), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim),
                            dtype=torch.float32, device=device),
    }

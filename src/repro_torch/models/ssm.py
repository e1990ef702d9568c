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
to the "model" devices and each computes its block
(:func:`_in_projection_blocks`).  ``out_proj`` split on its rows is row
parallel (:func:`_out_projection`).  Train and prefill join the blocks
on the home device and run the conv, the chunked scan and the gate whole
there, as the reference gathers the scan's input with every head
present.  The decode step (:func:`_decode`, for one device and the
mesh alike: there each field is one whole block) updates the state
where ``cache_specs`` keep it: the conv on each channel block of
``ssm_conv``, the recurrence on each head block of ``ssm_h``, each on
its "model" device, which receives only the new token's columns it
lacks; a head block's gated output is the row block its ``out_proj``
piece takes.
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
    if state is not None:  # ---- O(1) decode update ------------------------
        assert u.shape[1] == 1
        y, (conv,), (h_new,) = _decode(ssm, cfg, u, [state["conv"]],
                                       [state["h"]])
        return y, {"h": h_new, "conv": conv}
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

    xbc, _ = _causal_conv(xbc, ssm.w("conv_w", dt_), ssm.w("conv_b", dt_))
    x = xbc[..., :di].reshape(bsz, s, h, p)
    b_mat = xbc[..., di: di + g * n].reshape(bsz, s, g, n)
    c_mat = xbc[..., di + g * n:].reshape(bsz, s, g, n)
    y = ssd_chunked(x, dt, a, b_mat, c_mat, chunk=min(cfg.ssm_chunk, s))
    y = y + x * ssm.w("d_skip", dt_)[None, None, :, None]
    y = y.reshape(bsz, s, di) * F.silu(z)
    return _out_projection(ssm, y), None


def _recurrence(h_prev, x, dt1, a, bh, ch) -> tuple:
    """One token's state update for the heads given, in float32:
    ``h_new = h_prev·exp(dt·a) + B⊗(x·dt)`` and ``y = C·h_new``.  h_prev:
    (B,H,N,P); x: (B,H,P); dt1: (B,H); a: (H,); bh, ch: (B,H,N) (each
    head's group's B and C).  Returns (y (B,H,P), h_new)."""
    f32 = torch.float32
    dec = torch.exp(dt1 * a[None])                       # (B,H)
    xh = x * dt1[..., None]                              # (B,H,P)
    # the reference's einsums "bhn,bhp->bhnp" and "bhn,bhnp->bhp" as an
    # outer product and a batched product (fewer host ops a call)
    h_new = h_prev * dec[..., None, None] + \
        bh.to(f32)[..., :, None] * xh.to(f32)[..., None, :]
    return (ch.to(f32)[..., None, :] @ h_new)[..., 0, :], h_new


def _in_projection_blocks(ssm: SSM, names, u: torch.Tensor) -> list:
    """``u @ w`` for each projection of ``names`` as its column blocks in
    order, each with the "model" index of the device that holds it: one
    block on ``u``'s device (index 0) for a projection whole there; for
    one the spec splits over "model", column parallel: ``u`` goes to the
    "model" devices (once for all of them) and device j computes block
    j."""
    dt = u.dtype
    devs = [partition.tp_devices(ssm.leaf(n)) for n in names]
    split = next((d for d in devs if d is not None), None)
    if split is not None:
        pos = partition.tp_positions()
        us = partition.broadcast(u, split, pos, pos[0])
    out = []
    for name, d in zip(names, devs):
        if d is None:
            out.append([(0, u @ ssm.w(name, dt))])
        else:
            out.append([(j, uj @ ssm.w(name, dt, j))
                        for j, uj in enumerate(us)])
    return out


def _in_projections(ssm: SSM, names, u: torch.Tensor) -> list:
    """``u @ w`` for each projection of ``names``, whole on ``u``'s
    device: a split projection's blocks are brought home and joined in
    order."""
    out = []
    for blocks in _in_projection_blocks(ssm, names, u):
        parts = [t for _, t in blocks]
        out.append(parts[0] if len(parts) == 1 else torch.cat(
            partition.to_home(parts, u.device), dim=-1))
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


def _take(pieces: list, lo: int, hi: int, j: int) -> torch.Tensor:
    """Columns ``[lo, hi)`` of a column space held as ``pieces`` —
    ``(lo, hi, "model" index, tensor)`` each — on "model" device ``j`` of
    the current batch shard: the columns held elsewhere are copied there
    (counted as "reshard" under segment "ssm_state") and joined in
    order."""
    out = []
    for a, b, k, t in pieces:
        a2, b2 = max(a, lo), min(b, hi)
        if a2 >= b2:
            continue
        part = t[..., a2 - a: b2 - a]
        if k != j:
            run, i = partition.current()
            with partition.segment("ssm_state"):
                part = partition.move(part, run.device(i, j),
                                      run.position(i, k), run.position(i, j))
        out.append(part)
    return out[0] if len(out) == 1 else torch.cat(out, dim=-1)


def _param_slice(ssm: SSM, name: str, j: int, lo: int, hi: int,
                 dt: torch.dtype | None = None) -> torch.Tensor:
    """Entries ``[lo, hi)`` (last dim) of the replicated leaf ``name``,
    cast to ``dt``: on a mesh, on the current batch shard's "model"
    device ``j`` (:meth:`partition.MeshRun.replica_slice`)."""
    leaf = ssm.leaf(name)
    if not isinstance(leaf, partition.Sharded):
        return (ssm.p(name) if dt is None else ssm.w(name, dt))[..., lo:hi]
    run, i = partition.current()
    return run.replica_slice(leaf, (id(ssm), name), i, j, lo, hi, dt)


def conv_blocks(ssm: SSM, cfg: ModelConfig, zxbcdt: list, conv: list,
                inplace: bool = False) -> tuple[list, list]:
    """The decode step's depthwise causal conv on each block of the conv
    state ``conv`` (split on channels, one block a "model" device, or
    one whole): block j's channels of the conv input (columns of the
    projections' output ``zxbcdt``, pieces as :func:`_take` reads them)
    go to device j, which convolves them with its slice of the
    replicated weights.  The conv has no term across channels, so each
    block is bitwise the whole conv's.  Returns the output as pieces and
    the new state's blocks (``inplace``: written into ``conv``'s, which
    are returned)."""
    dt = zxbcdt[0][3].dtype
    c = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    width = c // len(conv)
    out, new = [], []
    for j, st in enumerate(conv):
        c0, c1 = j * width, (j + 1) * width
        xbc = _take(zxbcdt, cfg.d_inner + c0, cfg.d_inner + c1, j)
        y, st_new = _causal_conv(xbc, _param_slice(ssm, "conv_w", j, c0, c1,
                                                   dt),
                                 _param_slice(ssm, "conv_b", j, c0, c1, dt),
                                 st)
        out.append((c0, c1, j, y))
        new.append(st.copy_(st_new) if inplace else st_new)
    return out, new


def _decode(ssm: SSM, cfg: ModelConfig, u: torch.Tensor, conv: list,
            hs: list, inplace: bool = False) -> tuple:
    """One token's update (``u``: (B, 1, D)) of a state held as blocks:
    ``conv`` the conv state's on channels, ``hs`` the SSM state's on
    heads — one each, whole, on one device; on a mesh, one a "model"
    device of the current batch shard where ``cache_specs`` split the
    field.  The projections' column blocks stay where they are computed;
    conv block j runs on its device (:func:`conv_blocks`); head block
    j's recurrence runs on device j, from its heads' x, dt and gate, and
    B and C whole (a head reads its group's), each copied there only
    where it lies elsewhere.  The reference's arithmetic, head by head.
    Where ``out_proj`` is split on its rows, head block j's gated output
    is the row block device j's piece takes, and the partial sums come
    home; else the output is joined at home first.  Returns (the output
    (B, 1, D) on ``u``'s device, the new conv blocks, the new head
    blocks); ``inplace``: each block is written as it is made (cast to
    the block's dtype), and the blocks given are returned."""
    di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.n_ssm_heads
    p, gn = di // h, g * n
    bsz = u.shape[0]
    dt_ = u.dtype
    names = (("in_proj",) if ssm.has("in_proj") else
             ("z_proj", "x_proj", "b_proj", "c_proj", "dt_proj"))
    zxbcdt, off = [], 0                 # columns: z | x | B | C | dt
    for blocks in _in_projection_blocks(ssm, names, u):
        for j, t in blocks:
            zxbcdt.append((off, off + t.shape[-1], j, t))
            off += t.shape[-1]
    xbc, new_conv = conv_blocks(ssm, cfg, zxbcdt, conv, inplace)
    nh = h // len(hs)
    ys, new_h = [], []
    for j, h_prev in enumerate(hs):
        h0, h1 = j * nh, (j + 1) * nh
        x = _take(xbc, h0 * p, h1 * p, j).reshape(bsz, nh, p)
        bc = _take(xbc, di, di + 2 * gn, j)
        dt_raw = _take(zxbcdt, 2 * di + 2 * gn + h0, 2 * di + 2 * gn + h1, j)
        z = _take(zxbcdt, h0 * p, h1 * p, j)
        dt1 = F.softplus(dt_raw.float() + _param_slice(
            ssm, "dt_bias", j, h0, h1))[:, 0]                # (B,nh)
        a = -torch.exp(_param_slice(ssm, "a_log", j, h0, h1))
        bh, ch = (repeat_heads(t.reshape(bsz, g, n), h // g, 1)[:, h0:h1]
                  for t in bc[:, 0].split(gn, dim=-1))       # (B,nh,N)
        y, h_new = _recurrence(h_prev, x, dt1, a, bh, ch)
        y = y.to(dt_) + x * _param_slice(ssm, "d_skip", j, h0, h1, dt_)[
            None, :, None]
        ys.append(y.reshape(bsz, 1, (h1 - h0) * p) * F.silu(z))
        new_h.append(h_prev.copy_(h_new) if inplace else h_new)
    if len(ys) > 1 and partition.tp_devices(ssm.leaf("out_proj")):
        pos = partition.tp_positions()
        parts = [yj @ ssm.w("out_proj", dt_, j) for j, yj in enumerate(ys)]
        y = partition.reduce_sum(parts, u.device, pos, pos[0])
    else:
        y = _out_projection(ssm, ys[0] if len(ys) == 1 else torch.cat(
            partition.to_home(ys, u.device), dim=-1))
    return y, new_conv, new_h


def mesh_decode(ssm: SSM, cfg: ModelConfig, u: torch.Tensor,
                state: dict) -> torch.Tensor:
    """:func:`apply_ssm`'s decode step for the current batch shard of a
    mesh run: ``state["h"]`` and ``state["conv"]`` are the shard's blocks
    of one layer's ``ssm_h`` and ``ssm_conv`` where ``cache_specs`` keep
    them, each updated in place where it lies (:func:`_decode`).
    Returns the block's output (B, 1, D) on the home device."""
    return _decode(ssm, cfg, u, state["conv"], state["h"], inplace=True)[0]


def init_ssm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.n_ssm_heads
    p = di // h
    conv_dim = di + 2 * g * n
    return {
        "h": torch.zeros((batch, h, n, p), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim),
                            dtype=torch.float32, device=device),
    }

"""Analytic roofline model per (arch × shape × mesh) cell.

Torch twin of ``repro.launch.roofline``: the same closed forms over the
config, on the same production meshes (``tp = 16``, 256 or 512 chips),
so a cell's FLOPs, HBM bytes and wire bytes equal the reference's
figure for figure.  The dry run (:mod:`repro_torch.launch.dryrun`)
traces one layer and scales it for the same reason the reference counts
a scan body once: every layer has the same body, so the step totals
come from closed forms (exact for FLOPs; the model is matmul-dominated;
documented coefficients for HBM traffic), while the trace gives the
proof that the sharded step runs, its per-device memory and the bytes
it copies between mesh positions.

The one change is the hardware: the reference's constants are a TPU's;
here they are a :class:`Hardware`, carried by each :class:`Roofline`,
and the default is the NVIDIA H100 SXM 80 GB (data sheet):

* 989e12 FLOP/s bf16 dense on the tensor cores;
* 3.35e12 B/s HBM3;
* 80e9 bytes of HBM;
* 50e9 B/s of link a card and direction: the 400 Gb/s InfiniBand NDR
  port each card of a DGX H100 has to other nodes.  A 16-wide "model"
  axis spans two 8-card nodes, so a ring over it crosses that link;
  NVLink's 900 GB/s (both directions, within one node of eight) does
  not bound such a ring.

Wire-byte conventions per chip: ring all-reduce of a Z-byte buffer over n
chips moves 2·Z·(n-1)/n; all-gather/reduce-scatter move Z·(n-1)/n;
all-to-all moves Z·(n-1)/n.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.configs.base import ModelConfig, ShapeCfg


@dataclass(frozen=True)
class Hardware:
    """One chip: peak FLOP/s (bf16, dense), HBM B/s, link B/s, HBM
    bytes."""

    peak_flops: float
    hbm_bw: float
    link_bw: float
    hbm_bytes: float


H100 = Hardware(peak_flops=989e12, hbm_bw=3.35e12, link_bw=50e9,
                hbm_bytes=80e9)

BF16 = 2
F32 = 4


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    # totals (global, per step)
    useful_flops: float = 0.0      # MODEL_FLOPS = 6·N·D (train) / 2·N·D
    hlo_flops: float = 0.0         # analytic compiled flops (incl. waste)
    hbm_bytes: float = 0.0         # per-chip HBM traffic
    wire_bytes: float = 0.0        # per-chip link traffic
    breakdown: dict = field(default_factory=dict)
    hw: Hardware = H100

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * self.hw.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.wire_bytes / self.hw.link_bw

    @property
    def bottleneck(self) -> str:
        t = {"compute": self.t_compute, "memory": self.t_memory,
             "collective": self.t_collective}
        return max(t, key=t.get)

    @property
    def useful_ratio(self) -> float:
        return self.useful_flops / max(self.hlo_flops, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """useful-FLOPs throughput at the bound ÷ peak (the score)."""
        t_bound = max(self.t_compute, self.t_memory, self.t_collective)
        return (self.useful_flops / (self.chips * t_bound)) / \
            self.hw.peak_flops

    def as_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "useful_flops": self.useful_flops, "hlo_flops": self.hlo_flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "wire_bytes_per_chip": self.wire_bytes,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "breakdown": self.breakdown,
        }


def _mlp_flops_tok(cfg: ModelConfig, d_ff: int) -> float:
    mults = 3 if cfg.act == "swiglu" else 2
    return 2.0 * cfg.d_model * d_ff * mults


def _attn_proj_flops_tok(cfg: ModelConfig) -> float:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head
    return 2.0 * d * (h + 2 * kv + h) * dh  # q,k,v,o


def _ssm_flops_tok(cfg: ModelConfig) -> float:
    d, di = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.n_ssm_heads
    p = di // h
    q = cfg.ssm_chunk
    zdim = 2 * di + 2 * g * n + h
    conv_dim = di + 2 * g * n
    intra = 2.0 * q * g * n + 2.0 * q * h * p        # CB + (w·x)
    inter = 2.0 * h * n * p * 2                       # states + y_inter
    return (2.0 * d * zdim + 2.0 * cfg.ssm_conv * conv_dim
            + intra + inter + 2.0 * di * d)


def _moe_flops_tok(cfg: ModelConfig, seq: int, useful: bool) -> float:
    e, k, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor
    expert = _mlp_flops_tok(cfg, cfg.expert_ff)
    if useful:
        return k * expert + 2.0 * cfg.d_model * e
    cap = cf * k * seq / e
    dispatch = 2.0 * e * cap * cfg.d_model * 2        # dispatch + combine
    return cf * k * expert + 2.0 * cfg.d_model * e + dispatch


def _layer_flops_tok(cfg: ModelConfig, seq: int, *, useful: bool,
                     ctx: float | None = None) -> float:
    """Forward flops per token per layer. ``ctx``: decode context length."""
    kind = cfg.family
    total = 0.0
    # attention
    if kind not in ("ssm",):
        total += _attn_proj_flops_tok(cfg)
        h, dh = cfg.n_heads, cfg.d_head
        if ctx is not None:                     # decode: attend over cache
            eff = ctx
            if cfg.sliding_window > 0:
                # all-but-global layers see only the window
                ge = cfg.global_layer_every or cfg.n_layers
                frac_global = 1.0 / ge
                eff = (frac_global * ctx
                       + (1 - frac_global) * min(cfg.sliding_window, ctx))
            total += 4.0 * h * dh * eff
        else:
            pairs = seq / 2 if useful else seq  # blockwise computes full S²
            if cfg.sliding_window > 0:
                ge = cfg.global_layer_every or cfg.n_layers
                frac_global = 1.0 / ge
                w = min(cfg.sliding_window, seq)
                pairs = frac_global * pairs + (1 - frac_global) * (
                    w if useful else w * 2)
            total += 4.0 * h * dh * pairs
    # mixer / mlp
    if kind == "ssm":
        total += _ssm_flops_tok(cfg)
    elif kind == "hybrid":
        total += _ssm_flops_tok(cfg) + _mlp_flops_tok(cfg, cfg.d_ff)
    elif kind == "moe":
        total += _moe_flops_tok(cfg, seq, useful)
    else:
        total += _mlp_flops_tok(cfg, cfg.d_ff)
    if cfg.family in ("encdec", "audio"):       # cross-attention
        total += _attn_proj_flops_tok(cfg)
        total += 4.0 * cfg.n_heads * cfg.d_head * (cfg.enc_seq_len / 1.0)
    return total


def _tp_sharded(cfg: ModelConfig, tp: int) -> dict:
    """Which blocks are TP vs FSDP under the rule engine (specs.py)."""
    return {
        "attn_tp": cfg.n_heads > 0 and cfg.n_heads % tp == 0,
        "mlp_tp": cfg.d_ff % tp == 0 if cfg.d_ff else False,
        "moe_ep": cfg.n_experts > 0 and cfg.n_experts % tp == 0,
        "moe_tp": cfg.n_experts > 0 and cfg.n_experts % tp != 0
                  and cfg.expert_ff % tp == 0,
        "vocab_tp": cfg.vocab % tp == 0,
    }


def roofline_cell(cfg: ModelConfig, shape: ShapeCfg, *,
                  multi_pod: bool = False, hw: Hardware = H100) -> Roofline:
    chips = 512 if multi_pod else 256
    tp = 16
    dp = chips // tp
    mesh_name = "pod2x16x16" if multi_pod else "16x16"
    b, s = shape.global_batch, shape.seq_len
    l = cfg.n_layers
    n_params = cfg.param_count()
    r = Roofline(cfg.name, shape.name, mesh_name, chips, hw=hw)
    sh = _tp_sharded(cfg, tp)

    if shape.kind in ("train", "prefill"):
        tokens = float(b * s)
        fwd_useful = tokens * (
            l * _layer_flops_tok(cfg, s, useful=True)
            + 2.0 * cfg.d_model * cfg.vocab)
        fwd_hlo = tokens * (
            l * _layer_flops_tok(cfg, s, useful=False)
            + 2.0 * cfg.d_model * cfg.vocab)
        if cfg.family in ("encdec", "audio"):
            enc_tok = float(b * cfg.enc_seq_len)
            fwd_useful += enc_tok * cfg.enc_layers * (
                _attn_proj_flops_tok(cfg) + _mlp_flops_tok(cfg, cfg.d_ff)
                + 2.0 * cfg.n_heads * cfg.d_head * cfg.enc_seq_len)
            fwd_hlo += enc_tok * cfg.enc_layers * (
                _attn_proj_flops_tok(cfg) + _mlp_flops_tok(cfg, cfg.d_ff)
                + 4.0 * cfg.n_heads * cfg.d_head * cfg.enc_seq_len)
        if shape.kind == "train":
            remat_extra = 1.0 if cfg.remat == "full" else 0.0
            r.useful_flops = 3.0 * fwd_useful          # MODEL_FLOPS ≈ 6·N·D
            r.hlo_flops = (3.0 + remat_extra) * fwd_hlo
        else:
            r.useful_flops = fwd_useful
            r.hlo_flops = fwd_hlo

        # ---- HBM traffic per chip -------------------------------------
        nmb = max(cfg.microbatch, 1) if shape.kind == "train" else 1
        passes = (2 + (1 if cfg.remat == "full" else 0)) if shape.kind == "train" else 1
        p_local = n_params * BF16 / chips
        param_traffic = p_local * nmb * passes
        if shape.kind == "train":
            # grads f32 r/w + opt state r/w (adam: m,v r+w; adafactor ~0)
            opt_mult = 4 if cfg.optimizer.startswith("adamw") else 1
            param_traffic += n_params * F32 / chips * (2 + opt_mult)
        act = tokens / chips * l * cfg.d_model * BF16 * 12 * (
            3 if shape.kind == "train" else 1)
        r.hbm_bytes = param_traffic + act
        r.breakdown["param_traffic"] = param_traffic
        r.breakdown["act_traffic"] = act

        # ---- collective wire bytes per chip ---------------------------
        wire = 0.0
        z_act = tokens * cfg.d_model * BF16 / dp     # per-data-shard act
        ar = lambda z, n: 2.0 * z * (n - 1) / n  # noqa: E731
        ag = lambda z, n: z * (n - 1) / n  # noqa: E731
        bwd = 2.0 if shape.kind == "train" else 1.0
        if sh["attn_tp"]:
            wire += l * ar(z_act, tp) * bwd
        elif cfg.n_heads:  # FSDP attention: AG params per use, RS grads
            attn_param_bytes = (l * cfg.d_model
                                * (2 * cfg.n_heads + 2 * cfg.n_kv)
                                * cfg.d_head * BF16)
            wire += attn_param_bytes * passes * nmb * (dp - 1) / dp
            if shape.kind == "train":
                wire += attn_param_bytes * 2 * (dp - 1) / dp  # grad RS f32
        if cfg.d_ff and sh["mlp_tp"]:
            wire += l * ar(z_act, tp) * bwd
        if cfg.family in ("ssm", "hybrid"):
            zdim = 2 * cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state \
                + cfg.n_ssm_heads
            if cfg.ssm_split_proj and cfg.d_inner % tp == 0:
                wire += l * ar(z_act, tp) * bwd      # TP AR per block
            else:  # fused in_proj: FSDP all-gather per pass + grad RS
                in_bytes = l * cfg.d_model * zdim * BF16
                wire += in_bytes * passes * nmb * (dp - 1) / dp
                if shape.kind == "train":
                    wire += in_bytes * 2 * (dp - 1) / dp
        if cfg.n_experts:
            if sh["moe_ep"]:   # token a2a there+back, fwd(+bwd)
                a2a = tokens * cfg.d_model * BF16 * cfg.top_k * cfg.capacity_factor / dp
                wire += l * 2 * a2a * (tp - 1) / tp * bwd
            elif sh["moe_tp"]:
                wire += l * ar(z_act, tp) * bwd
        if shape.kind == "train":
            # grad all-reduce over data of model-sharded grads (f32)
            g_local = n_params * F32 / tp
            wire += ar(g_local, dp)
            if multi_pod:
                r.breakdown["cross_pod_ar"] = ar(n_params * F32 / (16 * tp), 2)
        if sh["vocab_tp"]:
            # logits AR/AG at the loss (chunked): f32 chunk activations
            wire += ag(tokens * F32 / dp * 8, tp)  # lse/gold partials
        r.wire_bytes = wire

    else:  # ---- decode -------------------------------------------------
        tokens = float(b)
        ctx = float(s)
        r.useful_flops = tokens * (
            l * _layer_flops_tok(cfg, 1, useful=True, ctx=ctx)
            + 2.0 * cfg.d_model * cfg.vocab)
        r.hlo_flops = r.useful_flops  # decode: no blockwise waste
        p_local = n_params * BF16 / chips
        cache_bytes = 0.0
        if cfg.family not in ("ssm",):
            kv_ctx = ctx
            if cfg.sliding_window > 0:
                ge = cfg.global_layer_every or cfg.n_layers
                kv_ctx = (ctx / ge + (1 - 1 / ge) * min(cfg.sliding_window, ctx))
            cache_elt = (1.0 + 1.0 / cfg.d_head * 2  # int8 + bf16 scale
                         if cfg.cache_dtype == "int8" else BF16)
            cache_bytes = (2 * l * kv_ctx * cfg.n_kv * cfg.d_head * cache_elt
                           * b / chips)
        if cfg.family in ("ssm", "hybrid"):
            di = cfg.d_inner
            cache_bytes += (l * cfg.n_ssm_heads * cfg.ssm_state
                            * (di // cfg.n_ssm_heads) * F32 * b / chips)
        r.hbm_bytes = p_local + cache_bytes
        r.breakdown["cache_read"] = cache_bytes
        r.breakdown["param_read"] = p_local

        wire = 0.0
        ar = lambda z, n: 2.0 * z * (n - 1) / n  # noqa: E731
        bdim = min(b, dp)
        z_act = tokens * cfg.d_model * BF16 / bdim
        if sh["attn_tp"] or (cfg.n_kv and cfg.n_kv % tp != 0):
            # TP AR (heads) or seq-sharded partial-softmax AR per layer
            wire += l * ar(z_act, tp)
        if cfg.d_ff and sh["mlp_tp"]:
            wire += l * ar(z_act, tp)
        if sh["vocab_tp"]:
            wire += tokens / bdim * cfg.vocab * F32 * (tp - 1) / tp  # logits AG
        r.wire_bytes = wire

    return r

"""Model / run configuration schema for the 10 assigned architectures.

One frozen dataclass covers dense / MoE / SSM / hybrid / enc-dec / VLM /
audio families; family-specific fields default to "off".  Exact per-arch
values live in ``repro_torch/configs/<id>.py``; every config also provides a
``smoke()`` reduction (same family, tiny dims) used by the CPU tests.
A plain copy of the reference's ``repro.configs.base``: same fields,
defaults and parameter count.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeCfg:
    """One (input-shape × step-kind) cell of the assigned grid."""

    name: str            # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES = (
    ShapeCfg("train_4k", 4_096, 256, "train"),
    ShapeCfg("prefill_32k", 32_768, 32, "prefill"),
    ShapeCfg("decode_32k", 32_768, 128, "decode"),
    ShapeCfg("long_500k", 524_288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeCfg:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense|moe|ssm|hybrid|encdec|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    d_ff: int
    vocab: int
    act: str = "swiglu"          # swiglu | gelu | relu2
    attn_bias: bool = False
    rope_theta: float = 1_000_000.0
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_d_ff: int = 0            # expert hidden dim (defaults to d_ff)
    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_chunk: int = 256
    # split the fused in_proj into per-stream projections so each becomes
    # tensor-parallel where divisible (z/x: d_inner, B/C: G·N) instead of
    # one FSDP-gathered fused matrix (§Perf hillclimb)
    ssm_split_proj: bool = False
    # hybrid (hymba): sliding-window attn with periodic global layers
    sliding_window: int = 0      # 0 = full attention everywhere
    global_layer_every: int = 0  # every k-th layer is full-attention
    # enc-dec
    enc_layers: int = 0
    enc_seq_len: int = 0
    # multimodal stub frontend (precomputed patch/frame embeddings)
    frontend_tokens: int = 0
    # numerics / training
    dtype: str = "bfloat16"      # compute dtype
    cache_dtype: str = "bfloat16"  # KV cache: bfloat16 | int8 (quantized)
    param_dtype: str = "float32"  # storage dtype (bf16 for >=100B configs)
    accum_dtype: str = "float32"  # grad-accumulation dtype
    optimizer: str = "adamw"     # adamw | adamw_bf16 | adafactor
    remat: str = "full"          # full | dots | none
    microbatch: int = 0          # 0 = no gradient accumulation
    # applicability notes (DESIGN.md §4)
    supports_long: bool = False  # sub-quadratic — long_500k runs
    notes: str = ""

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or max(self.d_inner // self.ssm_head_dim, 1)

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # --- parameter count (for MODEL_FLOPS = 6·N·D roofline term) ---------
    def param_count(self, active_only: bool = False) -> int:
        d, h, kv, dh, ff, v = (self.d_model, self.n_heads, self.n_kv,
                               self.d_head, self.d_ff, self.vocab)
        attn = d * h * dh + 2 * d * kv * dh + h * dh * d
        if self.attn_bias:
            attn += (h + 2 * kv) * dh
        if self.act == "swiglu":
            mlp = 3 * d * ff
        else:
            mlp = 2 * d * ff
        if self.n_experts:
            eff = self.expert_ff
            per_expert = 3 * d * eff if self.act == "swiglu" else 2 * d * eff
            n_exp = self.top_k if active_only else self.n_experts
            mlp = per_expert * n_exp + d * self.n_experts  # + router
        ssm = 0
        if self.family in ("ssm", "hybrid"):
            di, g, n, hh = self.d_inner, self.ssm_groups, self.ssm_state, self.n_ssm_heads
            ssm = d * (2 * di + 2 * g * n + hh) + di * d + di * self.ssm_conv + 2 * hh
        per_layer = mlp + 2 * d
        if self.family == "ssm":
            per_layer = ssm + 2 * d
        elif self.family == "hybrid":
            per_layer = attn + ssm + mlp + 3 * d
        else:
            per_layer += attn
        total = self.n_layers * per_layer + v * d + d
        if not self.tie_embeddings:
            total += d * v
        if self.family == "encdec":
            enc_per = attn + mlp + 2 * d
            cross = d * h * dh + 2 * d * kv * dh + h * dh * d
            total += self.enc_layers * enc_per + self.n_layers * cross
        return int(total)

"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 16 experts top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

16 experts = model axis width → clean expert parallelism (one expert per
model rank); heads=40 → FSDP attention fallback.  long_500k skipped
(full attention modeled; iRoPE chunked attention not modeled — noted in
DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "llama4-scout-17b-a16e"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv=8, d_head=128,
        d_ff=8192, vocab=202048, act="swiglu",
        n_experts=16, top_k=1, capacity_factor=1.25, moe_d_ff=8192,
        rope_theta=500_000.0, microbatch=8,
        supports_long=False,
        notes="EP 16e/16 ranks; top-1 routing (Switch-style).",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv=2, d_head=32, d_ff=256,
        vocab=512, n_experts=4, top_k=1, moe_d_ff=128, microbatch=0,
        dtype="float32")

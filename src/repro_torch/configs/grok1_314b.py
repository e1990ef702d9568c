"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2, logit softcap 30.
[hf:xai-org/grok-1; unverified]

8 experts do not divide the 16-wide model axis → tensor parallelism
*inside* each expert on the ffn dim (32768 = 16·2048) instead of EP.
bf16 Adam moments keep optimizer state at 256 chips under HBM.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "grok-1-314b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        n_layers=64, d_model=6144, n_heads=48, n_kv=8, d_head=128,
        d_ff=32768, vocab=131072, act="gelu",
        n_experts=8, top_k=2, capacity_factor=1.25, moe_d_ff=32768,
        logit_softcap=30.0, rope_theta=10_000.0, microbatch=16,
        optimizer="adafactor", param_dtype="bfloat16", accum_dtype="bfloat16",
        supports_long=False,
        notes="8e top-2; TP-inside-expert (E%16!=0); adafactor.",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv=2, d_head=32, d_ff=256,
        vocab=512, n_experts=2, top_k=2, moe_d_ff=128, microbatch=0,
        dtype="float32")

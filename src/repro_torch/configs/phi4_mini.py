"""phi4-mini-3.8b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064, RoPE SwiGLU GQA, tied embeddings.  [arXiv:2412.08905; hf]
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "phi4-mini-3.8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=32, d_model=3072, n_heads=24, n_kv=8, d_head=128,
        d_ff=8192, vocab=200064, act="swiglu", tie_embeddings=True,
        rope_theta=10_000.0, microbatch=2,
        supports_long=False,
        notes="tied embeddings; heads=24 -> FSDP attention fallback.",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv=2, d_head=32, d_ff=256,
        vocab=512, microbatch=0, dtype="float32")

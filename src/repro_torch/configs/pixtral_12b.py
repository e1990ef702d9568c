"""pixtral-12b [vlm] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072; pixtral-ViT frontend + mistral-nemo backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]

Per the assignment the ViT frontend is a STUB: ``input_specs`` provides
precomputed patch embeddings (B, frontend_tokens, d_model) which are
early-fused into the first positions of the sequence.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "pixtral-12b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="vlm",
        n_layers=40, d_model=5120, n_heads=32, n_kv=8, d_head=128,
        d_ff=14336, vocab=131072, act="swiglu",
        rope_theta=1_000_000.0, frontend_tokens=256, microbatch=4,
        supports_long=False,
        notes="stub ViT frontend (precomputed patch embeddings).",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv=2, d_head=32, d_ff=256,
        vocab=512, frontend_tokens=8, microbatch=0, dtype="float32")

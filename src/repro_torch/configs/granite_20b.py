"""granite-20b [dense] — 52L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152, llama-arch, code.  [arXiv:2405.04324; hf]

MQA: the single kv head is replicated across the model axis (57 MB/layer
— negligible); q heads 48 = 3·16 → tensor-parallel.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "granite-20b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=52, d_model=6144, n_heads=48, n_kv=1, d_head=128,
        d_ff=24576, vocab=49152, act="swiglu",
        rope_theta=10_000.0, microbatch=4,
        supports_long=False,
        notes="MQA kv=1 (replicated kv projections).",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv=1, d_head=32, d_ff=256,
        vocab=512, microbatch=0, dtype="float32")

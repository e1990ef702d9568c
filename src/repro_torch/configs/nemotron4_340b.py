"""nemotron-4-340b [dense] — 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000, squared-ReLU.  [arXiv:2402.16819; unverified]

Memory note: 340B params cannot hold fp32 Adam moments at 256 chips
(21 GB/chip) — config pins Adafactor (factored second moment), the
standard ≥100B choice.  96 heads = 6·16 → fully tensor-parallel attention.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "nemotron-4-340b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=96, d_model=18432, n_heads=96, n_kv=8, d_head=192,
        d_ff=73728, vocab=256000, act="relu2",
        rope_theta=10_000.0, microbatch=16, optimizer="adafactor",
        param_dtype="bfloat16", accum_dtype="bfloat16", cache_dtype="int8",
        supports_long=False,
        notes="squared-ReLU MLP; GQA kv=8; Adafactor for state fit.",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=8, n_kv=2, d_head=16, d_ff=512,
        vocab=512, microbatch=0, dtype="float32")

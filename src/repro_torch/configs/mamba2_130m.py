"""mamba2-130m [ssm] — 24L d_model=768 (attention-free) vocab=50280,
ssm_state=128, SSD (state-space duality).  [arXiv:2405.21060; unverified]

Attention-free: the paper's KY sampler still applies (token sampling),
but attention-sharding rules are vacuous (DESIGN.md §4).  O(1) decode
state → long_500k RUNS.  d_inner=1536, 24 SSD heads of dim 64.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "mamba2-130m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="ssm",
        n_layers=24, d_model=768, n_heads=0, n_kv=0, d_head=0,
        d_ff=0, vocab=50280, tie_embeddings=True,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
        ssm_chunk=128, microbatch=8,
        supports_long=True,
        notes="attention-free SSD; O(1) decode state.",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, vocab=512, ssm_state=16, ssm_head_dim=32,
        microbatch=0, dtype="float32")

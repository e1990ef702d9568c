"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16; parallel attn+mamba heads.
[arXiv:2411.13676; hf]

Hybrid block: attention and SSM heads read the same normed input in
parallel, outputs averaged (the Hymba recipe).  Sliding-window attention
everywhere except every 16th layer + the last (global) — with the SSM
state carrying long-range context, long_500k RUNS for this arch.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "hymba-1.5b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv=5, d_head=64,
        d_ff=5504, vocab=32001, act="swiglu",
        ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
        sliding_window=1024, global_layer_every=16, ssm_chunk=128, microbatch=2,  # §Perf C: fused_mb2 winner
        rope_theta=10_000.0,
        supports_long=True,
        notes="parallel attn+SSM heads; SWA + periodic global layers.",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv=2, d_head=32, d_ff=256,
        vocab=512, ssm_state=16, ssm_head_dim=32, sliding_window=8,
        global_layer_every=2, microbatch=0, dtype="float32")

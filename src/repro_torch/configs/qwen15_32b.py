"""qwen1.5-32b [dense] — 64L d_model=5120 40H (MHA kv=40) d_ff=27392
vocab=152064, QKV bias.  [hf:Qwen/Qwen1.5-0.5B family; hf]

Sharding note: 40 heads do not divide the 16-wide model axis → attention
weights fall back to FSDP-over-data (DESIGN.md §6); d_ff 27392 = 16·1712
keeps the MLP tensor-parallel.  long_500k skipped (pure full attention).
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen1.5-32b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=64, d_model=5120, n_heads=40, n_kv=40, d_head=128,
        d_ff=27392, vocab=152064, act="swiglu", attn_bias=True,
        rope_theta=1_000_000.0, microbatch=8, optimizer="adamw_bf16",
        cache_dtype="int8",  # §Perf A: 1.94x decode memory-term win
        supports_long=False,
        notes="MHA with QKV bias; heads=40 -> FSDP attention fallback.",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv=4, d_head=32, d_ff=256,
        vocab=512, microbatch=0, dtype="float32")

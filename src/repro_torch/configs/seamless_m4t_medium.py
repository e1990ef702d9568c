"""seamless-m4t-medium [audio] — 12L d_model=1024 16H (kv=16) d_ff=4096
vocab=256206, enc-dec, multimodal.  [arXiv:2308.11596; hf]

Per the assignment the speech frontend is a STUB: ``input_specs``
provides precomputed frame embeddings (B, enc_seq_len, d_model) consumed
by the bidirectional encoder; the causal decoder cross-attends.  Enc-dec
(not encoder-only) → decode shapes RUN; long_500k skipped (full attn).
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "seamless-m4t-medium"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="audio",
        n_layers=12, d_model=1024, n_heads=16, n_kv=16, d_head=64,
        d_ff=4096, vocab=256206, act="gelu",
        enc_layers=12, enc_seq_len=1024,
        rope_theta=10_000.0,
        supports_long=False,
        notes="enc-dec; stub speech frontend (precomputed frames).",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv=4, d_head=32, d_ff=256,
        vocab=512, enc_layers=2, enc_seq_len=16, microbatch=0,
        dtype="float32")

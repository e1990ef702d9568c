"""Config registry: ``--arch <id>`` resolution (plain dataclasses, no
framework) and the inputs of each (arch x shape) cell.  The same ten
architectures as the reference's ``repro.configs``."""
from __future__ import annotations

import torch

from repro_torch.configs import (
    granite_20b,
    grok1_314b,
    hymba_1_5b,
    llama4_scout,
    mamba2_130m,
    nemotron4_340b,
    phi4_mini,
    pixtral_12b,
    qwen15_32b,
    seamless_m4t_medium,
)
from repro_torch.configs.aia_paper import MCMC_CONFIGS
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeCfg, shape_by_name

_MODULES = (
    qwen15_32b, nemotron4_340b, phi4_mini, granite_20b, pixtral_12b,
    hymba_1_5b, llama4_scout, grok1_314b, seamless_m4t_medium, mamba2_130m,
)

ARCHS = {m.ARCH_ID: m for m in _MODULES}
ARCH_IDS = tuple(ARCHS.keys())


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    m = ARCHS[arch_id]
    return m.smoke() if smoke else m.config()


def cell_runnable(cfg: ModelConfig, shape: ShapeCfg) -> tuple[bool, str]:
    """Whether an (arch × shape) cell runs (sub-quadratic archs only at
    long_500k)."""
    if shape.name == "long_500k" and not cfg.supports_long:
        return False, "long_500k skipped: pure full-attention arch"
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeCfg) -> dict:
    """Stand-ins for every model input of a cell: tensors on the ``meta``
    device (shape and dtype, no memory), the counterpart of the
    reference's ``ShapeDtypeStruct``s.

    train/prefill: token batches (+ stub frontend embeddings); decode:
    the last token (caches come from ``init_cache`` on ``meta``)."""
    b, s = shape.global_batch, shape.seq_len

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    i32, f32 = torch.int32, torch.float32
    if shape.kind == "train":
        out = {"tokens": sds((b, s), i32), "labels": sds((b, s), i32)}
    elif shape.kind == "prefill":
        out = {"tokens": sds((b, s), i32)}
    else:  # decode: one new token against a seq_len cache
        out = {"tokens": sds((b, 1), i32)}
    if cfg.family == "vlm" and shape.kind != "decode":
        out["frontend"] = sds((b, cfg.frontend_tokens, cfg.d_model), f32)
    if cfg.family in ("encdec", "audio"):
        out["src_embeds"] = sds((b, cfg.enc_seq_len, cfg.d_model), f32)
    return out


__all__ = [
    "ARCHS", "ARCH_IDS", "MCMC_CONFIGS", "SHAPES", "ModelConfig", "ShapeCfg",
    "cell_runnable", "get_config", "input_specs", "shape_by_name",
]

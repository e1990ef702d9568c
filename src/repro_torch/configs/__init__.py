"""Config registry: ``--arch <id>`` resolution (plain dataclasses, no
framework).  The same ten architectures as the reference's
``repro.configs``; ``input_specs`` belongs to the dry run, which is not
ported."""
from __future__ import annotations

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


__all__ = [
    "ARCHS", "ARCH_IDS", "MCMC_CONFIGS", "SHAPES", "ModelConfig", "ShapeCfg",
    "cell_runnable", "get_config", "shape_by_name",
]

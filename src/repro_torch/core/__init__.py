"""AIA core: threefry bit streams, fixed point, LUT interpolation,
non-normalized Knuth-Yao sampling and the KY token sampler, as plain
PyTorch functions (the exports of the reference's ``repro.core``)."""
from repro_torch.core.cdf import CDFResult, cdf_sample
from repro_torch.core.fixedpoint import (
    DEFAULT_K,
    Quantizer,
    dequantize,
    entropy_bits,
    quantize_logits,
    quantize_probs,
    tv_distance,
)
from repro_torch.core.interp import (
    InterpTable,
    exp_table,
    iu_exp_weights,
    iu_log,
    log_table,
    sigmoid_table,
    softplus_table,
)
from repro_torch.core.ky import KYResult, ky_sample, ky_sample_ref
from repro_torch.core.token_sampler import (
    TokenSample,
    categorical_baseline,
    ky_sample_tokens,
    ky_sample_weights_hier,
    vocab_k,
)

__all__ = [
    "CDFResult", "cdf_sample", "DEFAULT_K", "Quantizer", "dequantize",
    "entropy_bits", "quantize_logits", "quantize_probs", "tv_distance",
    "InterpTable", "exp_table", "iu_exp_weights", "log_table",
    "sigmoid_table", "softplus_table", "iu_log", "KYResult", "ky_sample",
    "ky_sample_ref", "TokenSample", "categorical_baseline",
    "ky_sample_tokens", "ky_sample_weights_hier", "vocab_k",
]

"""Flash attention kernels: causal or full online-softmax attention with
float32 running max, sum and accumulator.

Two hand-written CUDA kernels for ``sm_90a`` replace the JAX package's
Pallas kernel ``repro.kernels.flash_attention._flash_kernel`` (launched by
``flash_attention`` and, through it, ``flash_mha``), one route per dtype:

- bfloat16 and float16: ``csrc/flash_attention_tc.cu``, ``wgmma`` on the
  tensor cores, K/V tiles through a TMA ring;
- float32: ``csrc/flash_attention.cu``, float32 FMAs on the CUDA cores.

The route is chosen by dtype, never on failure: the tensor cores would run
float32 as TF32, which keeps about three decimal digits, and the float32
checks hold 2e-5.  The plain PyTorch version is
:func:`repro_torch.kernels.ref.mha_ref`, dense softmax; the kernels agree
with it within a tolerance, since their sums are taken in another order.

The layouts are the reference's: :func:`flash_attention` on
``(BH, S, dh)``, :func:`flash_mha` on ``(B, S, H, dh)`` with GQA kv heads
``(B, S, KV, dh)``, head ``h`` reading kv head ``h // (H // KV)`` as
``jnp.repeat(..., axis=2)`` expands them.  On the card ``flash_mha``
reads the kv heads in place and writes ``(B, S, H, dh)`` directly; the
kernels' tiles are their own, and ``q_block``/``kv_block`` only reject the
shapes the reference rejects (``S`` not a multiple of the block).  The
tensor-core kernel reads through TMA, which takes head dims that are
multiples of 8: other head dims are zero-padded to one before the launch
(the zeros add nothing to the scores, and their output columns are cut).

Both take the plain version only for tensors that lie on the CPU; on a
CUDA tensor they launch a kernel or raise.  ``flash_attention.launches_tc``
and ``flash_attention.launches_simt`` count each route's launches and
``flash_attention.launches`` their sum.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _common
from repro_torch.kernels import ref as ref_lib

# widest head the kernels hold (compile-time cap)
MAX_HEAD_DIM = 128
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# the tensor-core kernel's dtype codes; float32 takes the CUDA-core kernel
_TC_DTYPES = {torch.bfloat16: 1, torch.float16: 2}
# the tensor-core kernel's TMA reads rows of 16-byte multiples
TC_HEAD_DIM_MULTIPLE = 8


def route(dtype: torch.dtype) -> str:
    """Which kernel takes q/k/v of ``dtype``: ``"tc"`` (tensor cores,
    bfloat16/float16) or ``"simt"`` (CUDA cores, float32)."""
    if dtype in _TC_DTYPES:
        return "tc"
    if dtype == torch.float32:
        return "simt"
    raise ValueError(f"flash attention takes float32, bfloat16 or float16, "
                     f"got {dtype}")


@functools.cache
def _entry(name: str):
    """The C entry point of kernel library ``name``, built at first use."""
    from repro_torch.kernels import _build

    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "flash_attention_tc":
        fn = _build.load(name).flash_attention_tc_launch
        fn.argtypes = [p] * 4 + [i] * 5 + [p, ctypes.c_float, i, i, p]
    else:
        fn = _build.load(name).flash_attention_launch
        fn.argtypes = [p] * 4 + [i] * 5 + [p, ctypes.c_float, i, p]
    fn.restype = i
    return fn


def pad_head_dim(t: torch.Tensor, multiple: int) -> torch.Tensor:
    """``t`` with its last (head) dim zero-padded up to a multiple of
    ``multiple``; ``t`` itself when it already is one."""
    dh = t.shape[-1]
    extra = -dh % multiple
    return F.pad(t, (0, extra)) if extra else t


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a fresh copy of it when its data is not 16-byte aligned
    (a TMA map's base address must be)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> torch.Tensor:
    """One launch of the dtype's kernel on (B, S, H, dh) q and (B, S, KV,
    dh) k/v, contiguous, on PyTorch's current stream; returns
    (B, S, H, dh)."""
    b, s, h, dh = q.shape
    tc = route(q.dtype) == "tc"
    if tc:
        q, k, v = (_aligned(pad_head_dim(t, TC_HEAD_DIM_MULTIPLE))
                   for t in (q, k, v))
    o = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(*(
        st for t in (q, k, v, o) for st in t.stride()[:3]))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h,
            int(k.shape[2]), s, int(q.shape[3]), strides, dh ** -0.5,
            int(bool(causal)))
    if tc:
        err = _entry("flash_attention_tc")(
            *args, _TC_DTYPES[q.dtype], _common.stream(q.device))
        flash_attention.launches_tc += 1
    else:
        err = _entry("flash_attention")(*args, _common.stream(q.device))
        flash_attention.launches_simt += 1
    _common.raise_on(err, f"flash_attention ({'tc' if tc else 'simt'})")
    flash_attention.launches += 1
    return o[..., :dh].contiguous() if o.shape[-1] != dh else o


def _check(q, k, v, q_block: int, kv_block: int) -> None:
    """Raise on what neither the kernel nor the reference takes."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash attention takes float32, bfloat16 or "
                         f"float16 q/k/v of one type, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    s, dh = q.shape[1], q.shape[-1]
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"flash attention takes head dims 1 to "
                         f"{MAX_HEAD_DIM}, got {dh}")
    for name, blk in (("q_block", q_block), ("kv_block", kv_block)):
        blk = min(blk, s)
        if blk < 1 or s % blk:
            raise ValueError(f"sequence length {s} is not a multiple of "
                             f"{name} {blk}")


def flash_attention(q, k, v, *, causal: bool = True, q_block: int = 256,
                    kv_block: int = 256, device=None) -> torch.Tensor:
    """Attention on (BH, S, dh) q/k/v (batch x heads flattened), scores
    scaled by ``dh ** -0.5``.  CPU tensors run the plain version; CUDA
    tensors launch the kernel.  Non-tensor inputs go to ``device``, by
    default the card."""
    q = _common.as_tensor(q, None, device)
    dev = q.device
    _common.check_device(dev, "flash_attention")
    k = _common.as_tensor(k, None, dev)
    v = _common.as_tensor(v, None, dev)
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention takes (BH, S, dh) q/k/v of one "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    _check(q, k, v, q_block, kv_block)
    if dev.type == "cpu":
        return ref_lib.mha_ref(q, k, v, causal=causal)
    out = _launch(q.contiguous()[:, :, None], k.contiguous()[:, :, None],
                  v.contiguous()[:, :, None], causal)
    return out[:, :, 0]


def flash_mha(q, k, v, *, causal: bool = True, q_block: int = 256,
              kv_block: int = 256, device=None) -> torch.Tensor:
    """GQA attention on (B, S, H, dh) q and (B, S, KV, dh) k/v, ``H`` a
    multiple of ``KV``; returns (B, S, H, dh).  CPU tensors run the plain
    version (kv heads expanded, heads flattened, :func:`ref.mha_ref`);
    CUDA tensors launch the kernel once."""
    q = _common.as_tensor(q, None, device)
    dev = q.device
    _common.check_device(dev, "flash_mha")
    k = _common.as_tensor(k, None, dev)
    v = _common.as_tensor(v, None, dev)
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_mha takes (B, S, H, dh) q and (B, S, KV, "
                         f"dh) k/v with KV dividing H, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    _check(q, k, v, q_block, kv_block)
    if dev.type == "cpu":
        return mha_plain(q, k, v, causal=causal)
    return _launch(q.contiguous(), k.contiguous(), v.contiguous(), causal)


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """Plain version of :func:`flash_mha` on any device: kv heads
    expanded, heads flattened into the batch, dense :func:`ref.mha_ref`."""
    b, s, h, dh = q.shape
    group = h // k.shape[2]
    k = torch.repeat_interleave(k, group, dim=2)
    v = torch.repeat_interleave(v, group, dim=2)

    def flat(t):
        return t.movedim(2, 1).reshape(b * h, s, dh)

    out = ref_lib.mha_ref(flat(q), flat(k), flat(v), causal=causal)
    return out.reshape(b, h, s, dh).movedim(1, 2)


flash_attention.launches = 0        # both routes
flash_attention.launches_tc = 0     # bfloat16/float16: tensor cores
flash_attention.launches_simt = 0   # float32: CUDA cores

"""Fused sweep kernel: the Gibbs sampling hot path in one CUDA kernel.

For each color the plan gather produces a (lanes, L) log-weight tile,
and everything downstream runs in one launch with the row in registers:

    label mask → max-subtract → IU-exp LUT interpolation
    → fixed-point floor (k-bit int32 weights) → per-lane KY DDG walk

The kernel (``csrc/fused_sweep.cu``, CUDA C++ for ``sm_90a``) replaces
the JAX package's Pallas kernel ``repro.kernels.fused_sweep._fused_kernel``.
Its plain PyTorch version is :func:`fused_gibbs_sample_ref`: the two-stage
``masked_exp_weights`` → ``ky_walk`` path, which makes the words of
``rng.random_bit_words``'s draw as it reads them (``rng.LaneWords``).

Bitwise contract: the kernel takes the color's key, not words, and makes
word ``j`` of lane ``i`` itself, when the lane's cursor first reaches it:
threefry2x32 of the counter ``(lane0 + i) * W + j`` over the global lane
axis, the word ``random_bit_words(key, (b,), 31 * max_attempts,
lane0=lane0)`` holds there (:func:`repro_torch.core.rng.lane_word` is its
scalar twin).  ``lane0`` is 0 for an unsharded call; a lane shard whose
first row is global row ``lane0`` passes it, and its rows then equal rows
``[lane0, lane0 + b)`` of the unsharded call.  A row map ``(N, colpos)``
(``colpos`` an int64 tensor of ``n_loc`` columns on the launch's device)
names rows that are not contiguous: lane ``i`` is global row ``(lane0 +
i // n_loc) * N + colpos[i % n_loc]``, so a site block's launch over the
nodes at positions ``colpos`` of a colour of ``N`` nodes draws the rows the
unsharded colour update gives them.  So
``sampler="cuda"`` returns the same samples, bits, attempts and ok flags
as ``sampler="torch"`` and as the reference's ``sampler="pallas"``/
``"xla"`` under the same key.  A group of ``next_pow2(L)`` threads (at
least 2) walks each lane.

:func:`fused_mrf_halfstep` launches the same kernel on an MRF grid: one
checkerboard colour update in one launch, the site energies made in the
kernel from the labels, the unary and the pairwise table, only the kept
parity walked, the labels written in place and the stats summed on the
card.  Site ``g`` (flat over ``(B, H, W)``) reads the words of global row
``lane0 + g``, the row the all-sites draw gives it, so the kept sites'
labels, bits and attempts are those of the plain version,
:func:`fused_mrf_halfstep_ref`: the energies of every site, the plain
sampler over all of them and the parity selected.

:func:`fused_bn_launcher` launches it on a Bayes net: one colour update
in one launch, each lane's own and child log-CPT rows gathered in the
kernel from the states by the colour's packed plan records
(:func:`pack_bn_plan`), the new states written in place and the stats
summed on the card.  Lane ``(b, i)``, node ``i`` of the colour's ``N`` in
chain ``b``, reads the words of global row ``(lane0 + b) * N + i``, the
row the gathered tile of ``pgm.compile._color_update`` gives it, so the
states, bits and attempts are those of the plain version,
:func:`fused_bn_update_ref`: the padded gathers and their fold,
:func:`fused_gibbs_sample_ref`, the write and the sums.

:func:`fused_gibbs_sample`, :func:`fused_mrf_halfstep` and
:func:`fused_bn_launcher` take the plain version only for tensors that
lie on the CPU; on a CUDA tensor they launch the kernel or raise.
``fused_gibbs_sample.launches`` counts the kernel's launches from all
three, and ``fused_gibbs_sample.shapes`` counts them by ``(b, L)`` (``b =
B * H * W`` for a grid's colour update, ``B * N`` for a Bayes net's).
"""
from __future__ import annotations

import collections
import ctypes
import functools
import threading

import numpy as np
import torch

from repro_torch.core import interp as interp_lib
from repro_torch.core import rng as rng_lib
from repro_torch.core.ky import KYResult, ky_walk
from repro_torch.kernels import _common

# masked-label log-weight floor — see core.interp.MASK_NEG
MASK_NEG = interp_lib.MASK_NEG

# largest fixed-point width for which masked labels quantize to weight 0:
# floor(exp(lo) * (2**k - 1)) == 0 with the exp LUT's lo = -16
MAX_FUSED_K = 23

# widest label axis the kernel holds in registers (compile-time cap)
MAX_FUSED_L = 32


# the kernel takes the lane count as a C int
MAX_FUSED_LANES = (1 << 31) - 1

# words of bit budget a lane: 31 bits an attempt, 32 attempts
_WORDS = rng_lib.bit_budget_words(31 * 32)

# threads a block of a grid or a Bayes-net colour update's launch
GRID_BLOCK = 256

_COUNT_LOCK = threading.Lock()


def launch_geometry(b: int, L: int, block_b: int) -> tuple[int, int]:
    """``(G, grid)`` of one launch: ``G = next_pow2(L)`` threads (at
    least 2) walk each of the ``b`` lanes, ``grid`` blocks of ``block_b``
    threads cover ``b * G`` threads.  The kernel indexes threads in 64
    bits, so ``b * G`` may pass 2**31 (from 2**26 lanes at L > 16); what
    it refuses — more than ``MAX_FUSED_LANES`` lanes, L outside [1, 32],
    a block that is not 32 to 1024 threads in whole warps — this refuses
    first, with no card needed."""
    if not 1 <= L <= MAX_FUSED_L:
        raise ValueError(f"fused kernel takes 1 <= L <= {MAX_FUSED_L} labels "
                         f"(got L={L})")
    if block_b < 32 or block_b > 1024 or block_b % 32:
        raise ValueError(f"fused kernel takes a block of 32 to 1024 threads, "
                         f"a multiple of 32 (got block_b={block_b})")
    if not 0 <= b <= MAX_FUSED_LANES:
        raise ValueError(f"fused kernel takes at most {MAX_FUSED_LANES} "
                         f"lanes (got b={b})")
    g = max(2, 1 << (L - 1).bit_length())
    return g, -(-b * g // block_b)    # under 2**31 blocks: b < 2**31, G <= 32


def _check_k(k: int) -> None:
    if k > MAX_FUSED_K:
        raise ValueError(
            f"fused sampler requires k <= {MAX_FUSED_K} so masked labels "
            f"quantize to weight 0 (got k={k})")


def _check_lane0(lane0: int) -> None:
    # the counter (lane0 + i) * W + j is a 64-bit integer
    if not 0 <= int(lane0) < 1 << 58:
        raise ValueError(f"lane0 must lie in [0, 2**58) (got {lane0})")


def _check_row_map(b: int, lane0: int, row_map, device) -> None:
    """A row map ``(N, colpos)`` the kernel takes: int64 columns on the
    launch's device that cut ``b`` rows into whole chains, and a largest
    global row, ``(lane0 + b // n_loc) * N - 1``, under 2**58."""
    stride, colpos = row_map
    if not (isinstance(colpos, torch.Tensor) and colpos.dtype == torch.int64
            and colpos.ndim == 1 and colpos.device == device
            and colpos.is_contiguous()):
        raise ValueError("row map columns must be a contiguous 1-D int64 "
                         f"tensor on {device}")
    n_loc = colpos.numel()
    if n_loc == 0 or b % n_loc or int(stride) < n_loc:
        raise ValueError(f"row map of {n_loc} columns over N={stride} does "
                         f"not cut {b} rows into whole chains")
    _check_lane0((int(lane0) + b // n_loc) * int(stride) - 1)


def _lane_card(card, b: int, device) -> torch.Tensor:
    if isinstance(card, int):   # a fill on the device, no host copy
        return torch.full((b,), card, dtype=torch.int32, device=device)
    card = torch.as_tensor(card, dtype=torch.int32, device=device)
    return torch.broadcast_to(card, (b,)).contiguous()


def _words(key, b: int, max_attempts: int, device,
           lane0: int = 0, row_map=None) -> rng_lib.LaneWords:
    """The exact stream ``ky_sample(key, ..., lane0=lane0,
    row_map=row_map)`` draws for rows ``[lane0, lane0 + b)`` of the
    global lane axis, or for the rows the map names, made as the plain
    version reads it."""
    return rng_lib.LaneWords(key, b, rng_lib.bit_budget_words(
        31 * max_attempts), lane0=lane0, row_map=row_map, device=device)


@functools.cache
def _entry():
    """The kernel library's C entry point, built at first use, with its
    argument types declared (ctypes would otherwise cut the pointers)."""
    from repro_torch.kernels import _build

    fn = _build.load("fused_sweep").fused_gibbs_sample_launch
    p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
    fn.argtypes = ([p, p, u, u, ctypes.c_uint64, p, ctypes.c_longlong,
                    ctypes.c_uint64] + [p] * 5
                   + [i, i, i, f, i, i, f, f, f, i, p])
    fn.restype = i
    return fn


@functools.cache
def _mrf_entry():
    """The grid colour update's C entry point, as :func:`_entry`."""
    from repro_torch.kernels import _build

    fn = _build.load("fused_sweep").fused_mrf_halfstep_launch
    p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
    q = ctypes.c_longlong
    fn.argtypes = ([p, p, p, p, q, p, q, p, ctypes.c_uint64, p]
                   + [i] * 5 + [f, i, i, f, f, i, i, p, u, u, i])
    fn.restype = i
    return fn


def _launch(logw: torch.Tensor, card: torch.Tensor, key,
            table: interp_lib.InterpTable, *, k: int, use_iu: bool,
            mask_value: float, max_attempts: int, block_b: int,
            lane0: int = 0, row_map=None) -> KYResult:
    """One launch of the CUDA kernel on PyTorch's current stream; the
    kernel makes its bit words from ``key``, lane ``i`` those of global
    row ``lane0 + i`` (or of the row ``row_map`` names)."""
    b, L = logw.shape
    launch_geometry(b, L, block_b)
    dev = logw.device
    tab = table.table.to(device=dev, dtype=torch.float32).contiguous()
    _common.check_input(logw, torch.float32, (b, L), dev, "fused kernel")
    _common.check_input(card, torch.int32, (b,), dev, "fused kernel")
    if tab.numel() != (1 << table.m) + 1:
        raise ValueError("LUT must hold 2**m + 1 nodes")
    colpos, n_loc, stride = 0, 0, 0
    if row_map is not None:
        _check_row_map(b, lane0, row_map, dev)
        colpos = row_map[1].data_ptr()
        n_loc, stride = row_map[1].numel(), int(row_map[0])
    k0, k1 = rng_lib._key_words(key)
    sample = torch.empty(b, dtype=torch.int32, device=dev)
    bits = torch.empty(b, dtype=torch.int32, device=dev)
    att = torch.empty(b, dtype=torch.int32, device=dev)
    ok = torch.empty(b, dtype=torch.bool, device=dev)
    # the launch goes to the tensors' card (a mesh's lane shards and tiles
    # may sit on several cards of one process)
    with torch.cuda.device(dev):
        err = _entry()(
            logw.data_ptr(), card.data_ptr(), k0, k1, int(lane0), colpos,
            n_loc, stride, tab.data_ptr(), sample.data_ptr(), bits.data_ptr(),
            att.data_ptr(), ok.data_ptr(), b, L,
            rng_lib.bit_budget_words(31 * max_attempts), float(2 ** k - 1),
            int(bool(use_iu)), 1 << table.m, float(table.lo),
            float(table.scale), float(mask_value), int(block_b),
            _common.stream(dev))
    _common.raise_on(err, "fused_gibbs_sample")
    _count_launch(b, L)
    return KYResult(sample=sample, bits_used=bits, attempts=att, ok=ok)


def _count_launch(b: int, L: int) -> None:
    """One launch more, and one more at ``(b, L)``: under a lock, since
    the serving workers' dispatcher threads launch concurrently."""
    with _COUNT_LOCK:
        fused_gibbs_sample.launches += 1
        fused_gibbs_sample.shapes[(b, L)] += 1


def _plain(logw: torch.Tensor, card: torch.Tensor, words,
           table: interp_lib.InterpTable, *, k: int, use_iu: bool,
           mask_value: float) -> KYResult:
    """The kernel's plain PyTorch version on the same inputs; ``words`` is
    a ``(b, W)`` tensor or a ``rng.LaneWords``, as ``ky_walk`` takes."""
    w = interp_lib.masked_exp_weights(
        logw, card, k, use_iu=use_iu, table=table, mask_value=mask_value)
    return ky_walk(w, words)


def fused_gibbs_sample(
    key,
    logw: torch.Tensor,        # (b, n) float32 gathered log-weights
    card,                      # (b,) int32 per-lane cardinality (or scalar)
    *,
    k: int,
    use_iu: bool = True,
    table: interp_lib.InterpTable | None = None,
    mask_value: float = MASK_NEG,
    max_attempts: int = 32,
    block_b: int = 256,
    lane0: int = 0,
    row_map=None,
) -> KYResult:
    """Fused distribution-generation + KY sampling, one lane per row.

    Drop-in replacement for the two-stage path

        ``ky_sample(key, masked_exp_weights(logw, card, k, ...))``

    with identical results bit for bit.  ``block_b`` is the CUDA block
    size in threads (a multiple of 32); results do not depend on it.
    ``lane0`` is the global row of this call's first lane (0 unless the
    call is a lane shard), and ``row_map`` an optional ``(N, colpos)``
    that names the call's rows instead (see the module docstring).  CPU
    tensors run the plain version; CUDA tensors launch the kernel, which
    makes its own bit words from ``key``.  Returns a :class:`KYResult`
    with (b,) fields.
    """
    _check_k(k)
    _check_lane0(lane0)
    logw = torch.as_tensor(logw, dtype=torch.float32)
    b = logw.shape[0]
    dev = logw.device
    _common.check_device(dev, "fused_gibbs_sample")
    card = _lane_card(card, b, dev)
    table = table or interp_lib._EXP_DEFAULT
    if row_map is not None:
        _check_row_map(b, lane0, row_map, dev)
    if dev.type == "cpu":
        return _plain(logw, card,
                      _words(key, b, max_attempts, dev, lane0, row_map),
                      table, k=k, use_iu=use_iu, mask_value=mask_value)
    return _launch(logw.contiguous(), card, key, table, k=k, use_iu=use_iu,
                   mask_value=mask_value, max_attempts=max_attempts,
                   block_b=block_b, lane0=lane0, row_map=row_map)


fused_gibbs_sample.launches = 0
fused_gibbs_sample.shapes = collections.Counter()   # (b, L) -> launches


def fused_gibbs_sample_ref(
    key,
    logw: torch.Tensor,
    card,
    *,
    k: int,
    use_iu: bool = True,
    table: interp_lib.InterpTable | None = None,
    mask_value: float = MASK_NEG,
    max_attempts: int = 32,
    lane0: int = 0,
    row_map=None,
) -> KYResult:
    """Plain PyTorch twin of :func:`fused_gibbs_sample` on any device:
    the shared helpers on the same bit words, made as the walk reads
    them."""
    _check_lane0(lane0)
    logw = torch.as_tensor(logw, dtype=torch.float32)
    b = logw.shape[0]
    if row_map is not None:
        _check_row_map(b, lane0, row_map, logw.device)
    card = _lane_card(card, b, logw.device)
    words = _words(key, b, max_attempts, logw.device, lane0, row_map)
    return _plain(logw, card, words, table or interp_lib._EXP_DEFAULT, k=k,
                  use_iu=use_iu, mask_value=mask_value)


def _mrf_operands(labels, unary, pairwise, acc, clamp, beta, lane0: int):
    """Check a grid colour update's operands as the kernel reads them,
    with no card needed, and return ``(clamp, clamp_chain, beta,
    beta_chain)``: the clamp mask (``(H, W)``, or ``(B, H, W)``/``(1, H,
    W)``) and β (scalar, ``(1,)`` or ``(B,)``, flattened) as contiguous
    tensors on the labels' device, None where not given, and their
    strides between chains (0 where every chain shares them)."""
    name = "fused MRF half-step"
    if not (isinstance(labels, torch.Tensor) and labels.ndim == 3):
        raise ValueError(f"{name}: labels must be a (B, H, W) tensor")
    B, H, W = labels.shape
    dev = labels.device
    _common.check_device(dev, name)
    L = unary.shape[-1] if unary.ndim else 0
    launch_geometry(B * H * W, L, GRID_BLOCK)
    _common.check_input(labels, torch.int32, (B, H, W), dev, name)
    _common.check_input(unary, torch.float32, (H, W, L), dev, name)
    _common.check_input(pairwise, torch.float32, (L, L), dev, name)
    _common.check_input(acc, torch.int64, (2,), dev, name)
    _check_lane0(lane0)
    _check_lane0(int(lane0) + max(B * H * W - 1, 0))
    clamp_chain = beta_chain = 0
    if clamp is not None:
        clamp = torch.as_tensor(clamp, dtype=torch.bool, device=dev)
        if not (tuple(clamp.shape) == (H, W) or (
                clamp.ndim == 3 and tuple(clamp.shape[1:]) == (H, W)
                and clamp.shape[0] in (1, B))):
            raise ValueError(f"{name}: clamp must be (H, W) or (B, H, W) = "
                             f"{(B, H, W)} (got {tuple(clamp.shape)})")
        clamp = clamp.contiguous()
        if clamp.ndim == 3 and clamp.shape[0] > 1:
            clamp_chain = H * W
    if beta is not None:
        beta = torch.as_tensor(beta, dtype=torch.float32, device=dev)
        if beta.ndim > 1 or beta.numel() not in (1, B):
            raise ValueError(f"{name}: beta must be a scalar or (B,) = "
                             f"({B},) (got {tuple(beta.shape)})")
        beta = beta.reshape(-1).contiguous()
        beta_chain = int(beta.numel() > 1)
    return clamp, clamp_chain, beta, beta_chain


def _check_parity(parity) -> None:
    if parity not in (0, 1):
        raise ValueError(f"fused MRF half-step: parity must be 0 or 1 (got "
                         f"{parity})")


def fused_mrf_launcher(
    labels: torch.Tensor,      # (B, H, W) int32, updated in place
    unary: torch.Tensor,       # (H, W, L) float32
    pairwise: torch.Tensor,    # (L, L) float32
    *,
    acc: torch.Tensor,         # (2,) int64: bits, attempts added to
    clamp=None,                # (H, W) or (B, H, W) bool, True = frozen
    beta=None,                 # inverse temperature, scalar or (B,)
    k: int,
    use_iu: bool = True,
    table: interp_lib.InterpTable | None = None,
    lane0: int = 0,
):
    """Check one label field's operands once and return ``launch(key,
    parity)``, which runs :func:`fused_mrf_halfstep` on them: a caller
    that updates the same field half-step after half-step (``mrf_gibbs``)
    pays the checks and the placing of the mask, β and the LUT once, and
    each launch only its key.  Every launch goes to the card's current
    stream as it was when the launcher was made.  The tensors are held,
    not copied: ``labels`` and ``acc`` are updated in place by every
    launch.  Refuses what the kernel does not take before anything runs;
    ``launch`` refuses a parity other than 0 or 1."""
    _check_k(k)
    clamp, clamp_chain, beta, beta_chain = _mrf_operands(
        labels, unary, pairwise, acc, clamp, beta, lane0)
    table = table or interp_lib._EXP_DEFAULT
    dev = labels.device
    if dev.type == "cpu":
        def launch(key, parity) -> None:
            _check_parity(parity)
            _plain_mrf(key, labels, unary, pairwise, parity, acc, clamp,
                       beta, k=k, use_iu=use_iu, table=table, lane0=lane0)
        return launch
    B, H, W = labels.shape
    L = unary.shape[-1]
    tab = table.table.to(device=dev, dtype=torch.float32).contiguous()
    if tab.numel() != (1 << table.m) + 1:
        raise ValueError("LUT must hold 2**m + 1 nodes")
    entry = _mrf_entry()
    fixed = (labels.data_ptr(), unary.data_ptr(), pairwise.data_ptr(),
             None if clamp is None else clamp.data_ptr(), clamp_chain,
             None if beta is None else beta.data_ptr(), beta_chain,
             acc.data_ptr(), int(lane0), tab.data_ptr(), B, H, W, L, _WORDS,
             float(2 ** k - 1), int(bool(use_iu)), 1 << table.m,
             float(table.lo), float(table.scale), GRID_BLOCK, dev.index,
             _common.stream(dev))
    held = (labels, unary, pairwise, acc, clamp, beta, tab)

    def launch(key, parity) -> None:
        _check_parity(parity)
        k0, k1 = rng_lib._key_words(key)
        _common.raise_on(entry(*fixed, k0, k1, int(parity)),
                         "fused_mrf_halfstep")
        _count_launch(B * H * W, L)
    launch.held = held     # the pointers' tensors live as long as launch
    return launch


def fused_mrf_halfstep(
    key,
    labels: torch.Tensor,      # (B, H, W) int32, updated in place
    unary: torch.Tensor,       # (H, W, L) float32
    pairwise: torch.Tensor,    # (L, L) float32
    parity: int,
    *,
    acc: torch.Tensor,         # (2,) int64: bits, attempts added to
    clamp=None,                # (H, W) or (B, H, W) bool, True = frozen
    beta=None,                 # inverse temperature, scalar or (B,)
    k: int,
    use_iu: bool = True,
    table: interp_lib.InterpTable | None = None,
    lane0: int = 0,
) -> None:
    """One checkerboard colour update of an MRF grid in one launch.

    Resamples the sites ``(h + w) % 2 == parity`` of every chain that
    ``clamp`` does not freeze, from their energies against the current
    labels (``unary[h, w, l]`` plus ``pairwise[l, m]`` of the in-grid
    neighbours, times β where given), writing the new labels into
    ``labels`` and adding the random bits the kept sites read and their
    attempts to ``acc``.  ``lane0`` is the global row of site ``(0, 0,
    0)``: a lane shard whose first chain is global chain ``c`` passes
    ``c * H * W``.  Equal bit for bit to ``checkerboard_halfstep``'s
    plain path under the same key.  CPU tensors run
    :func:`fused_mrf_halfstep_ref`; CUDA tensors launch the kernel.
    Refuses what the kernel does not take before anything runs.
    """
    _check_parity(parity)
    fused_mrf_launcher(labels, unary, pairwise, acc=acc, clamp=clamp,
                       beta=beta, k=k, use_iu=use_iu, table=table,
                       lane0=lane0)(key, parity)


def _plain_mrf(key, labels, unary, pairwise, parity, acc, clamp, beta, *,
               k: int, use_iu: bool, table: interp_lib.InterpTable,
               lane0: int) -> KYResult:
    """The grid colour update's plain version on checked operands."""
    # the plain energies live in pgm.gibbs, which imports this module
    from repro_torch.pgm.gibbs import neighbor_pair_energy

    B, H, W = labels.shape
    L = unary.shape[-1]
    dev = labels.device
    e = unary[None] + neighbor_pair_energy(labels, pairwise)
    if beta is not None:
        e = e * beta[:, None, None, None]
    n = B * H * W
    res = _plain(-e.reshape(n, L), _lane_card(L, n, dev),
                 _words(key, n, 32, dev, lane0), table, k=k, use_iu=use_iu,
                 mask_value=MASK_NEG)
    ar_h = torch.arange(H, device=dev)
    ar_w = torch.arange(W, device=dev)
    keep = (((ar_h[:, None] + ar_w[None, :]) % 2) == int(parity))[None]
    if clamp is not None:
        keep = keep & ~clamp.reshape(-1, H, W)
    labels.copy_(torch.where(keep, res.sample.reshape(B, H, W), labels))
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    acc += torch.stack([
        torch.where(keep, f.reshape(B, H, W), zero).sum()
        for f in (res.bits_used, res.attempts)])
    return res


def fused_mrf_halfstep_ref(
    key,
    labels: torch.Tensor,
    unary: torch.Tensor,
    pairwise: torch.Tensor,
    parity: int,
    *,
    acc: torch.Tensor,
    clamp=None,
    beta=None,
    k: int,
    use_iu: bool = True,
    table: interp_lib.InterpTable | None = None,
    lane0: int = 0,
) -> KYResult:
    """Plain PyTorch twin of :func:`fused_mrf_halfstep` on any device:
    every site's energies, β and negation, :func:`fused_gibbs_sample_ref`
    over all ``B * H * W`` rows, and the kept sites selected; ``labels``
    and ``acc`` are updated in place as the kernel updates them.  Returns
    the draw of every site (the kept sites' rows are the kernel's)."""
    _check_k(k)
    _check_parity(parity)
    clamp, _, beta, _ = _mrf_operands(labels, unary, pairwise, acc, clamp,
                                      beta, lane0)
    return _plain_mrf(key, labels, unary, pairwise, parity, acc, clamp, beta,
                      k=k, use_iu=use_iu,
                      table=table or interp_lib._EXP_DEFAULT, lane0=lane0)


def pack_bn_plan(plan, bank, n_states: int) -> np.ndarray:
    """One colour's plan as the kernel reads it: an ``(N, (4 + 2P)(1 +
    C))`` int32 array, a row a node, of 1 + C blocks of 4 + 2P words: its
    own ``[node, card, CPT offset, real children, P parent ids, P
    strides]``, then one a child slot ``[CPT offset, stride of the node
    in the child's table, child id, stride of the child's own axis, P
    other-parent ids, P strides]``.  ``plan`` has the fields of
    ``pgm.compile.ColorPlan`` (arrays); ``bank`` is the flat log-CPT bank
    it indexes and ``n_states`` the states a chain.  A node's real
    children are its slots before the trailing ones that read the
    bank's last entry with every stride 0, where that entry is +0.0 (the
    compile chain's sentinel): the kernel adds +0.0 for those without a
    load, as the plain path adds the sentinel it reads."""
    f = {k: np.asarray(torch.as_tensor(getattr(plan, k)).cpu(), np.int64)
         for k in ("nodes", "card", "self_base_off", "self_pa",
                   "self_pa_stride", "ch_off", "ch_vstride", "ch_self",
                   "ch_self_stride", "ch_pa", "ch_pa_stride")}
    bank = np.asarray(torch.as_tensor(bank).cpu(), np.float32).reshape(-1)
    last = bank.size - 1
    n, c = f["ch_off"].shape
    sentinel = bank.size > 0 and bank[last] == 0 and not np.signbit(
        bank[last])
    pad = (sentinel & (f["ch_off"] == last) & (f["ch_vstride"] == 0)
           & (f["ch_self_stride"] == 0) & (f["ch_pa_stride"] == 0).all(-1))
    n_ch = c - np.cumprod(pad[:, ::-1], axis=1).sum(1)
    own = np.concatenate([np.stack([f["nodes"], f["card"],
                                    f["self_base_off"], n_ch], 1),
                          f["self_pa"], f["self_pa_stride"]], 1)
    ch = np.concatenate([np.stack([f["ch_off"], f["ch_vstride"],
                                   f["ch_self"], f["ch_self_stride"]], 2),
                         f["ch_pa"], f["ch_pa_stride"]], 2)
    ids = np.concatenate([f["nodes"], f["self_pa"].ravel(), f["ch_self"].ravel(),
                          f["ch_pa"].ravel()])
    if ids.size and not (0 <= ids.min() and ids.max() < n_states):
        raise ValueError(f"plan names a state outside [0, {n_states})")
    if not ((1 <= f["card"]) & (f["card"] <= MAX_FUSED_L)).all():
        raise ValueError(f"plan cards must lie in [1, {MAX_FUSED_L}]")
    rec = np.concatenate([own[:, None], ch], 1).reshape(n, -1)
    if np.abs(rec).max(initial=0) >= 1 << 31:
        raise ValueError("plan record words must fit int32")
    return rec.astype(np.int32)


@functools.cache
def _bn_entry():
    """The Bayes-net colour update's C entry point, as :func:`_entry`."""
    from repro_torch.kernels import _build

    fn = _build.load("fused_sweep").fused_bn_update_launch
    p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
    q = ctypes.c_longlong
    fn.argtypes = ([p, q, p, q, p, q, p, ctypes.c_uint64, p]
                   + [i] * 5 + [f, i, i, f, f, f, i, i, p, p, i, u, u])
    fn.restype = i
    return fn


def _bn_operands(states, bank, records, acc, beta, *, P: int, L: int,
                 lane0: int):
    """Check a Bayes net's colour update operands as the kernel reads
    them, with no card needed, and return ``(records, C, beta,
    beta_chain)``: the records as a tuple, their child slots, and β
    (scalar, ``(1,)`` or ``(B,)``) flattened on the states' device, None
    where not given, with its stride between chains."""
    name = "fused BN colour update"
    if not (isinstance(states, torch.Tensor) and states.ndim == 2):
        raise ValueError(f"{name}: states must be a (B, n) tensor")
    B, n = states.shape
    dev = states.device
    _common.check_device(dev, name)
    _common.check_input(states, torch.int32, (B, n), dev, name)
    if not (isinstance(bank, torch.Tensor) and bank.ndim == 1
            and bank.numel() > 0):
        raise ValueError(f"{name}: bank must be a non-empty 1-D tensor")
    _common.check_input(bank, torch.float32, (bank.numel(),), dev, name)
    _common.check_input(acc, torch.int64, (2,), dev, name)
    records = tuple(records)
    width = 4 + 2 * P
    if P < 1 or not records:
        raise ValueError(f"{name}: needs P >= 1 and at least one record")
    C = records[0].shape[-1] // width - 1 if records[0].ndim == 2 else 0
    _check_lane0(lane0)
    for r in records:
        if not (isinstance(r, torch.Tensor) and r.ndim == 2 and r.shape[0]
                and C >= 1):
            raise ValueError(f"{name}: records must be non-empty (N, (4 + "
                             f"2P)(1 + C)) tensors, C >= 1")
        _common.check_input(r, torch.int32, (r.shape[0], width * (1 + C)),
                            dev, name)
        launch_geometry(B * r.shape[0], L, GRID_BLOCK)
        _check_lane0((int(lane0) + B) * r.shape[0] - 1)
    beta_chain = 0
    if beta is not None:
        beta = torch.as_tensor(beta, dtype=torch.float32, device=dev)
        if beta.ndim > 1 or beta.numel() not in (1, B):
            raise ValueError(f"{name}: beta must be a scalar or (B,) = "
                             f"({B},) (got {tuple(beta.shape)})")
        beta = beta.reshape(-1).contiguous()
        beta_chain = int(beta.numel() > 1)
    return records, C, beta, beta_chain


def fused_bn_launcher(
    states: torch.Tensor,      # (B, n) int32, updated in place
    bank: torch.Tensor,        # flat float32 log-CPT bank
    records,                   # a colour's (N, (4 + 2P)(1 + C)) int32 each
    *,
    P: int,                    # parent slots of a record block
    L: int,                    # label slots of a lane (the widest card)
    acc: torch.Tensor,         # (2,) int64: bits, attempts added to
    beta=None,                 # inverse temperature, scalar or (B,)
    k: int,
    use_iu: bool = True,
    table: interp_lib.InterpTable | None = None,
    lane0: int = 0,
):
    """Check a Bayes net's operands once and return ``launch(key,
    color)``: one colour update of ``records[color]`` (from
    :func:`pack_bn_plan`, for states of ``n`` columns) in one launch.
    Lane ``(b, i)`` resamples node ``i`` of the colour in chain ``b`` from
    its own CPT row and its children's, gathered from the current states
    (``L`` labels, those past the node's card masked), times β where
    given (after the valid labels' max is subtracted), writes the new
    state into ``states`` and adds its random bits and attempts to
    ``acc``; it reads the words of global row ``(lane0 + b) * N + i``,
    ``lane0`` being the first chain's global index.  Equal bit for bit to
    :func:`fused_bn_update_ref`, and so to ``_color_update``'s plain
    path, under the same key.  The tensors are held, not copied; every
    launch goes to the card's current stream as it was when the launcher
    was made.  CPU tensors run the plain version.  Refuses what the
    kernel does not take before anything runs."""
    _check_k(k)
    records, C, beta, beta_chain = _bn_operands(
        states, bank, records, acc, beta, P=P, L=L, lane0=lane0)
    table = table or interp_lib._EXP_DEFAULT
    dev = states.device
    if dev.type == "cpu":
        def launch(key, color) -> None:
            _plain_bn(key, states, records[color], bank, acc, beta, P=P,
                      L=L, k=k, use_iu=use_iu, table=table, lane0=lane0)
        return launch
    B, n = states.shape
    tab = table.table.to(device=dev, dtype=torch.float32).contiguous()
    if tab.numel() != (1 << table.m) + 1:
        raise ValueError("LUT must hold 2**m + 1 nodes")
    entry = _bn_entry()
    fixed = (states.data_ptr(), n, bank.data_ptr(), bank.numel(),
             None if beta is None else beta.data_ptr(), beta_chain,
             acc.data_ptr(), int(lane0), tab.data_ptr(), B, P, C, L, _WORDS,
             float(2 ** k - 1), int(bool(use_iu)), 1 << table.m,
             float(table.lo), float(table.scale), MASK_NEG, GRID_BLOCK,
             dev.index, _common.stream(dev))
    colours = [(r.data_ptr(), r.shape[0]) for r in records]

    def launch(key, color) -> None:
        k0, k1 = rng_lib._key_words(key)
        ptr, N = colours[color]
        _common.raise_on(entry(*fixed, ptr, N, k0, k1), "fused_bn_update")
        _count_launch(B * N, L)
    launch.held = (states, bank, records, acc, beta, tab)
    return launch


def _plain_bn(key, states, record, bank, acc, beta, *, P: int, L: int,
              k: int, use_iu: bool, table: interp_lib.InterpTable,
              lane0: int) -> KYResult:
    """The Bayes-net colour update's plain version on checked operands:
    the padded (B, N, L) and (B, N, C, L) gathers of the bank by the
    record, the child slots past the real ones taken as +0.0, the left
    fold over C, β, :func:`fused_gibbs_sample_ref` and the write."""
    dev = states.device
    B = states.shape[0]
    N, width = record.shape
    S = 4 + 2 * P
    rec = record.to(torch.int64).reshape(N, width // S, S)
    own, ch = rec[:, 0], rec[:, 1:]                      # (N, S), (N, C, S)
    nodes, card, n_ch = own[:, 0], own[:, 1], own[:, 3]
    xl = states.to(torch.int64)
    ls = torch.arange(L, device=dev)
    last = bank.numel() - 1

    def parents(blk):   # sum_j stride_j * x[:, id_j] over a block's slots
        return (blk[..., 4 + P:][None] * xl[:, blk[..., 4:4 + P]]).sum(-1)

    base = own[:, 2][None] + parents(own)                          # (B, N)
    logw = bank[torch.clamp(base[..., None] + ls, 0, last)]        # (B, N, L)
    ch_base = ch[..., 0][None] + parents(ch) + ch[..., 3][None] * xl[
        :, ch[..., 2]]                                             # (B, N, C)
    terms = bank[torch.clamp(ch_base[..., None]
                             + ch[..., 1][None, ..., None] * ls, 0, last)]
    real = torch.arange(ch.shape[1], device=dev) < n_ch[:, None]   # (N, C)
    terms = torch.where(real[None, ..., None], terms, 0.0)
    ch_sum = terms[:, :, 0]
    for c in range(1, terms.shape[2]):
        ch_sum = ch_sum + terms[:, :, c]
    logw = logw + ch_sum
    if beta is not None:
        valid = ls[None, None, :] < card[None, :, None]
        m = torch.amax(torch.where(valid, logw, -torch.inf), dim=-1,
                       keepdim=True)
        logw = (logw - m) * (beta[:, None, None] if beta.numel() > 1
                             else beta)
    res = fused_gibbs_sample_ref(
        key, logw.reshape(-1, L), card.to(torch.int32)[None].expand(
            B, N).reshape(-1), k=k, use_iu=use_iu, table=table,
        lane0=int(lane0) * N)
    states[:, nodes] = res.sample.reshape(B, N).to(states.dtype)
    acc += torch.stack([res.bits_used.sum(dtype=torch.int64),
                        res.attempts.sum(dtype=torch.int64)])
    return res


def fused_bn_update_ref(
    key,
    states: torch.Tensor,
    record: torch.Tensor,
    bank: torch.Tensor,
    *,
    P: int,
    L: int,
    acc: torch.Tensor,
    beta=None,
    k: int,
    use_iu: bool = True,
    table: interp_lib.InterpTable | None = None,
    lane0: int = 0,
) -> KYResult:
    """Plain PyTorch twin of one launch of :func:`fused_bn_launcher` on
    any device: the record's padded gathers of the bank and their fold,
    β, :func:`fused_gibbs_sample_ref` over all ``B * N`` lanes, the
    states written and the stats added to ``acc``, in place as the kernel
    updates them.  Returns the draw of every lane."""
    _check_k(k)
    (record,), _, beta, _ = _bn_operands(states, bank, [record], acc, beta,
                                         P=P, L=L, lane0=lane0)
    return _plain_bn(key, states, record, bank, acc, beta, P=P, L=L, k=k,
                     use_iu=use_iu, table=table or interp_lib._EXP_DEFAULT,
                     lane0=lane0)

"""The yardstick: the H100's peaks and the least time the work of one
checkerboard half-step needs, counted from the cell's shapes.

The count is of what the algorithm needs, not of what a kernel takes
today, so it holds if the energies move into a kernel or a launch covers
one parity only:

* bytes: every site's label read once (one byte a label: a uint8 holds
  any L up to 256), the (H, W, L) float32 unary and the (L, L) float32
  pairwise table read once, and the updated parity's labels written once;
* operations: for each updated site and label, the four neighbour terms
  and the unary term added (5), and for each random bit the walk reads,
  one column of L weight bits summed (L).

The least time is the larger of bytes over the memory bandwidth and
operations over the float32 rate of the CUDA cores.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 80GB, "NVIDIA H100 Tensor Core GPU" data sheet
# (nvidia.com, 2023): HBM3 bandwidth 3.35 TB/s; FP32 (CUDA cores, no
# tensor cores) 67 TFLOP/s.  Both at the card's full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

LABEL_BYTES = 1
FLOAT_BYTES = 4
ENERGY_OPS_PER_LABEL = 5


def halfstep_bytes(chains: int, height: int, width: int, labels: int) -> int:
    sites = height * width
    kept = chains * updated_sites(height, width)
    return (chains * sites * LABEL_BYTES
            + sites * labels * FLOAT_BYTES
            + labels * labels * FLOAT_BYTES
            + kept * LABEL_BYTES)


def updated_sites(height: int, width: int) -> int:
    """Sites of the larger parity of one chain (parity 0 holds the
    ceiling half)."""
    return (height * width + 1) // 2


def halfstep_ops(chains: int, height: int, width: int, labels: int,
                 bits: float) -> float:
    """``bits``: random bits the walk read over the half-step's updated
    sites (the program's own count)."""
    kept = chains * updated_sites(height, width)
    return kept * labels * ENERGY_OPS_PER_LABEL + bits * labels


def least_time_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S)


def halfstep_least_time_s(chains: int, height: int, width: int, labels: int,
                          bits: float) -> float:
    """The least time of one half-step on the card."""
    return least_time_s(halfstep_bytes(chains, height, width, labels),
                        halfstep_ops(chains, height, width, labels, bits))

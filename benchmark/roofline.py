"""Peaks of the card and the operations and bytes of the port's kernels.

Frozen here so that a change to the program cannot move the yardstick.

Peaks: NVIDIA's published figures for one H100 SXM at its 700 W limit
(dense rates): HBM3 at 3.35 TB/s, 67 TFLOP/s of fp32 on the CUDA cores
(an FMA counts 2). A card set below 700 W runs slower; the run prints its
power limit beside every share.

Kernel work is counted from the inputs, whatever implements it:

* nearest neighbour (`csrc/nn.cu`): every query screened against every
  valid reference (3 FMA = 6 operations and a min, 7 a pair) and at least
  one group of 8 rows a query rescored in the direct form (8 a row); bytes:
  queries and references read once (12 bytes a row), the reference mask
  (1 byte a row), the (d2, index) pair written once a query (8 bytes);
* the KD build's level sort (`csrc/sort.cu`): every row of a (c, m) key
  sorted; a key (4 bytes), its coordinates (12) and its index (4) are read
  once and written once.
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def bound_s(bytes_moved: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the fp32 rate, in seconds."""
    return max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS)


def nn_work(nq: int, nr: int, n_valid: int) -> Tuple[float, float]:
    """(bytes, operations) of one exact 1-NN search of nq queries over nr
    reference rows, n_valid of them valid."""
    return float((nq + nr) * 12 + nr + nq * 8), float(nq * n_valid * 7 + nq * 8 * 8)


def sort_bytes(c: int, m: int) -> float:
    """Bytes of one level sort of a (c, m) key with its coordinates and
    index: each read once and written once."""
    return float(c * m * 2 * (4 + 12 + 4))

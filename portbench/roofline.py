"""Peaks of the card and the work kernels K1 (chaining DP, csrc/chain.cu)
and K2 (chain backtrack, csrc/backtrack.cu) need.

Frozen from chip_smoke.py (commit 112cabc5c64b): ``bound``, the
operation counts per unit of work and ``k1_bound``'s pair count.
Changed: the counts are per read (a row of the batch), from the read's
anchor count alone (reference/anchors.py), and a read's needed work
only (its anchors, not the batch's padded slots), so that the bound of
a window is the sum over the reads it mapped, whatever batches the
runtime formed.  The launch parameters are the map-ont defaults of the
port at that commit (config.py ``pallas_chain_window``,
``backtrack_k``, ``length_buckets``; models/pipeline.py ``SEG_LEN``).

Peaks of one NVIDIA H100 SXM (data sheet): HBM3 at 3.35 TB/s.  The
int32 rate is derived, not published: 64 INT32 lanes per SM (Hopper
white paper) x the SM count read from the card x the 1.98 GHz boost
clock; 132 SMs give 16.7 Top/s.  Both assume the full 700 W power
limit; the run prints the card's limit beside them.
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
BOOST_HZ = 1.98e9
# integer operations counted per unit of work (the recurrence's own
# arithmetic, not its addressing): K1 per (anchor, predecessor) pair —
# the distance gates and the gap penalty; K2 per candidate per pass —
# valid/used/threshold tests and the max
OPS_PER_PAIR_K1 = 16
OPS_PER_CAND_K2 = 3
#: K1's predecessor window H; K2's chains per read K; the read lengths
#: the front end launches at; query bases per K2 cut
CHAIN_WINDOW = 128
BACKTRACK_K = 8
LENGTH_BUCKETS = (512, 1024, 2048, 8192, 32768, 131072)
SEG_LEN = 384


def int32_ops_per_s(sm_count: int) -> float:
    return INT32_LANES_PER_SM * sm_count * BOOST_HZ


def bound_s(nbytes: float, nops: float, sm_count: int) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the int32 operations over the int32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, nops / int32_ops_per_s(sm_count))


def k1_work(n: np.ndarray):
    """Per read of n anchors: (bytes, ops) K1 needs: the five int32
    fields and the valid byte of each anchor read once, its f and p
    written once; anchor i scored against its min(i, H) predecessors
    (the valid anchors of a row are its first n, in order)."""
    n = np.asarray(n, np.float64)
    H = CHAIN_WINDOW
    pairs = np.where(n <= H, n * (n - 1) / 2,
                     H * (H + 1) / 2 + (n - 1 - H) * H)
    return n * (5 * 4 + 1 + 8), np.maximum(pairs, 0) * OPS_PER_PAIR_K1


def length_bucket(n: int) -> int:
    """The length a read of n bases is launched at."""
    for b in LENGTH_BUCKETS:
        if n <= b:
            return b
    return LENGTH_BUCKETS[-1]


def k2_work(n: np.ndarray, read_lens: np.ndarray):
    """Per read of n anchors and its length: (bytes, ops) K2 needs at the
    least: f and valid of each anchor read once for the candidate scan,
    the read's chain table written once (K rows of 9 + 2 cuts int32),
    K passes over the candidates.  The walks along the chains' p are
    left out, so that the count is never above what the kernel must
    do."""
    n = np.asarray(n, np.float64)
    cuts = np.array([min(8, length_bucket(int(x)) // SEG_LEN)
                     for x in read_lens], np.float64)
    K = BACKTRACK_K
    return n * 5 + K * (9 + 2 * cuts) * 4, K * n * OPS_PER_CAND_K2

"""Extension DP parameters and direction-byte layout (host side).

The slice maps with the host C++ banded extension (native/post_chain.cc
and the native job batches), so only what the host path and
ops/cigar.py read lives here: the scoring parameters, the direction
byte layout of the banded DP and the static band placement.  The
device extension DP (``extend_dp`` and its kernel) is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple


class ExtendParams(NamedTuple):
    a: int  # match score (>0)
    b: int  # mismatch penalty (>0)
    q: int
    e: int
    q2: int
    e2: int
    sc_ambi: int  # penalty vs ambiguous base (>0)


# direction byte layout
H_SRC_MASK = 0x07  # 0=diag 1=E1 2=E2 3=F1 4=F2
E1_CONT = 0x08
E2_CONT = 0x10
F1_CONT = 0x20
F2_CONT = 0x40


def band_lo_host(s: int, qlen: int, tlen: int, W: int):
    """Host mirror of the in-kernel band placement (for traceback).
    qlen/tlen accepted for interface stability; the band is static."""
    return max(s // 2 - W // 2 + 1, 0)

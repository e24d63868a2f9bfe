"""minimap2's 64-bit minimizer hash on int64 tensors.

The JAX package carries hashes as (hi, lo) uint32 pairs because a TPU
has no fast 64-bit integer path.  Torch has native int64, so keys are
plain int64 here, for every k the presets use (k <= 28: keys of at most
2k <= 56 bits).

Unsigned 64-bit arithmetic on int64: addition and left shifts wrap in
two's complement (``key << 31`` of a 56-bit key leaves int64's range),
so their low 64 bits are those of the unsigned result, and the mask to
2k bits after each such step keeps the value in [0, 2^(2k)).  Every
right shift is applied to such a masked, non-negative value, where
int64's arithmetic shift equals the logical one.
"""
from __future__ import annotations

import torch


def mask_bits(bits: int) -> int:
    return (1 << bits) - 1


def hash64(key: torch.Tensor, k: int) -> torch.Tensor:
    """Invertible integer mix hash over the low 2k bits (minimap2's
    hash64, the index/sketch_host.py oracle), for int64 keys < 4^k.

    Bit-exact with hash64 in unsigned 64-bit arithmetic (see the module
    docstring): ~key is negative, and the wrapped sum is masked before
    the next shift."""
    m = mask_bits(2 * k)
    key = (~key + (key << 21)) & m
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & m
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & m
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & m
    return key

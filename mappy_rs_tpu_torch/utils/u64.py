"""minimap2's 64-bit minimizer hash on int64 tensors.

The JAX package carries hashes as (hi, lo) uint32 pairs because a TPU
has no fast 64-bit integer path.  Torch has native int64, so keys are
plain int64 here.  This slice supports k <= 15: keys are then at most
2k <= 30 bits, every intermediate of ``hash64`` (the widest is
key << 31, < 2^61) fits int64 without overflow, and the value is masked
to 2k bits before each shift.  Larger k raises: those keys need the
unsigned 64-bit arithmetic the two-word index layout uses, which is
not ported yet.
"""
from __future__ import annotations

import torch

MAX_K = 15


def mask_bits(bits: int) -> int:
    return (1 << bits) - 1


def check_k(k: int) -> None:
    if k > MAX_K:
        raise NotImplementedError(
            f"k={k}: keys wider than 30 bits (k > {MAX_K}) need the two-word "
            "hash path, which is not ported yet (ROADMAP Queue 1 item 2)"
        )


def hash64(key: torch.Tensor, k: int) -> torch.Tensor:
    """Invertible integer mix hash over the low 2k bits (minimap2's
    hash64, the index/sketch_host.py oracle), for int64 keys < 4^k.

    Bit-exact with hash64 in unsigned 64-bit arithmetic: the masked
    steps keep the value below 2^(2k), the unmasked xor/shift steps
    cannot widen it, and int64 two's-complement wraparound of ~key is
    erased by the mask that follows."""
    check_k(k)
    m = mask_bits(2 * k)
    key = (~key + (key << 21)) & m
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & m
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & m
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & m
    return key

"""Independent random streams from one --seed: one per purpose, so a
part of a run draws the same values whatever the other parts draw."""
from __future__ import annotations

import numpy as np

#: stream ids: the genome, the timed reads, the warm-up reads, the
#: check's sample, the warm-up's reads of the mix's edge lengths
GENOME, READS, WARMUP, SAMPLE, EDGES = 1, 2, 3, 4, 5


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def torch_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for a torch.Generator of this stream."""
    ss = np.random.SeedSequence([int(seed), stream])
    return int(ss.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)

"""The synthetic reference genome of a configuration, made on the
device from the seed.

The model is mappy_rs_tpu_torch/tools/gbp_chip.py's ``GenomeModel`` /
``build_genome`` (commit 112cabc5c64b), rebuilt with a torch.Generator
on the card in a few large calls instead of numpy on the host: the
same shape (``contigs`` contigs of ``contig_len`` random bases, then
copies of a repeat library pasted without overlaps, each copy with
``repeat_divergence`` substitutions), other bytes for a seed.  The
library is ``repeat_library``: [count, length] pairs of elements.  The
copies are either drawn at random from the library until they cover
``repeat_share`` of the genome (the hg38-like model) or are exactly
``repeat_copies`` copies drawn from it.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from . import seeds


@dataclasses.dataclass
class Genome:
    codes: np.ndarray  # uint8 [n] base codes 0..3, the contigs end to end
    names: List[str]
    starts: np.ndarray  # int64 [n_contigs] offset of each contig in codes
    lens: np.ndarray  # int64 [n_contigs]
    repeat_bp: int  # bases covered by pasted copies

    def contigs(self):
        """(name, codes view) pairs in index order."""
        return [(n, self.codes[s:s + ln])
                for n, s, ln in zip(self.names, self.starts, self.lens)]


def make_genome(cfg: dict, seed: int, device) -> Genome:
    g = cfg
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seeds.torch_seed(seed, seeds.GENOME))
    n_ctg, ctg_len = int(g["contigs"]), int(g["contig_len"])
    n = n_ctg * ctg_len
    buf = torch.randint(0, 4, (n,), dtype=torch.uint8, device=dev,
                        generator=gen)
    lib = [torch.randint(0, 4, (int(length),), dtype=torch.uint8,
                         device=dev, generator=gen)
           for count, length in g["repeat_library"]
           for _ in range(int(count))]
    lens_lib = torch.tensor([len(e) for e in lib], dtype=torch.int64,
                            device=dev)
    if "repeat_copies" in g:
        n_copies = int(g["repeat_copies"])
        ids = torch.randint(0, len(lib), (n_copies,), device=dev,
                            generator=gen)
    else:
        target = int(float(g["repeat_share"]) * n)
        est = int(1.2 * target / float(lens_lib.float().mean()))
        ids = torch.randint(0, len(lib), (est,), device=dev, generator=gen)
        ids = ids[torch.cumsum(lens_lib[ids], 0) <= target]
    lens = lens_lib[ids]
    # non-overlapping dispersed placement: the random-sequence budget
    # spread as gaps between the copies (gbp_chip's rule)
    gap_total = n - int(lens.sum())
    gaps = torch.rand(len(ids) + 1, dtype=torch.float64, device=dev,
                      generator=gen)
    gaps = torch.floor(gaps / gaps.sum() * gap_total).to(torch.int64)
    prev = torch.cat([lens.new_zeros(1), lens[:-1]])
    starts = torch.cumsum(gaps[:-1] + prev, 0)
    div = float(g["repeat_divergence"])
    for j, e in enumerate(lib):
        sel = starts[ids == j]
        if not len(sel):
            continue
        idx = (sel[:, None] + torch.arange(len(e), device=dev)).reshape(-1)
        copies = e.expand(len(sel), len(e)).reshape(-1).clone()
        mut = torch.rand(copies.shape, device=dev, generator=gen) < div
        rot = torch.randint(1, 4, (int(mut.sum()),), dtype=torch.uint8,
                            device=dev, generator=gen)
        copies[mut] = (copies[mut] + rot) & 3
        buf[idx] = copies
    codes = buf.cpu().numpy()
    del buf
    return Genome(
        codes=codes,
        names=[f"{g.get('name_prefix', 'ctg')}{i:02d}" for i in range(n_ctg)],
        starts=np.arange(n_ctg, dtype=np.int64) * ctg_len,
        lens=np.full(n_ctg, ctg_len, np.int64),
        repeat_bp=int(lens.sum()),
    )

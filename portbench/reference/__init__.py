"""The plain reference that judges the timed path's records, and its
control.  It shares no code with the port and imports nothing of it.

``Reference(genome, cfg)`` holds the genome that the harness hands both
sides and the preset's scoring (the configuration's ``scoring``).  For
the sampled reads, their truth (where each was drawn, and how far its
path drifts) and the program's records, ``judge`` gives the numbers
that decide ``correct``:

- ``records_inconsistent``: sampled reads with a record whose fields
  disagree with the read and the genome it names (records.py: the
  CIGAR's spans, mlen, blen, NM, cs, the coordinates, mapq in 0..60),
  or with records but none primary.  Exact: limit 0.
- ``score_gap_pct``: over the sampled reads drawn from the genome, the
  widest gap by which the best primary record's alignment score lies
  below the best local alignment of the read near where it was drawn
  (dp.py), in % of the latter; 100 for a read left unmapped.  The
  reference's DP is exact integer arithmetic; a record elsewhere that
  scores as well reads 0 or below.

``control_records`` is the reference put in the program's place with
the configuration's guarantee "exact integer DP" broken: the same DP
with its scores kept in bfloat16, its best path walked back into a
record.  ``kernel_work`` counts the work kernels K1 and K2 need for a
set of reads from a plain count of their anchors (anchors.py).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import roofline
from . import anchors, dp
from .records import Scoring, encode, judge_read, make_record, revcomp

#: bases of band kept beyond a read's drift on either side
BAND_MARGIN = 64
#: reads per block of the control's DP (its traceback is kept whole)
CONTROL_BLOCK = 64


class Reference:
    def __init__(self, genome, cfg: dict, device="cpu"):
        self.genome = genome
        self.cfg = cfg
        self.sc = Scoring(**{k: int(v) for k, v in cfg["scoring"].items()})
        self.device = device
        self.contigs = dict(genome.contigs())

    # ------------------------------------------------------------ the DP
    @staticmethod
    def _blocks(idx: List[int], codes, size: Optional[int]):
        if size is None:
            return [idx]
        idx = sorted(idx, key=lambda r: len(codes[r]))
        return [idx[i:i + size] for i in range(0, len(idx), size)]

    def _run(self, reads: Sequence[str], truths, rounding=None,
             traceback=False, block=None):
        """Per read with a truth: its best local score, and with
        `traceback` its best path as a record."""
        codes = [encode(s) for s in reads]
        idx = [r for r, t in enumerate(truths) if t is not None]
        best: Dict[int, int] = {}
        recs: Dict[int, list] = {}
        g = self.genome
        for blk in self._blocks(idx, codes, block):
            if not blk:
                continue
            W = max(dp.band_of(truths[r][3], truths[r][4], BAND_MARGIN)[1]
                    for r in blk)
            qs, wins, at = [], [], []
            for r in blk:
                ctg, start, rev, lo, hi = truths[r]
                d, _ = dp.band_of(lo, hi, BAND_MARGIN)
                q = revcomp(codes[r]) if rev else codes[r]
                w0 = start + d - W
                qs.append(q)
                wins.append(dp.windows_of(g.codes, int(g.starts[ctg]),
                                          int(g.starts[ctg] + g.lens[ctg]),
                                          w0, len(q) + 2 * W + 1))
                at.append(w0)
            scores, paths = dp.best_local(qs, wins, W, self.sc, self.device,
                                          rounding, traceback)
            for j, r in enumerate(blk):
                best[r] = int(scores[j])
                if paths is None:
                    continue
                recs[r] = []
                if paths[j] is not None:
                    recs[r] = [self._record(codes[r], truths[r], at[j],
                                            paths[j])]
        return best, recs

    def _record(self, read, truth, w0, path):
        ctg, _start, rev, _lo, _hi = truth
        qs_f, qe_f, ws, we, cigar = path
        n = len(read)
        qs, qe = (n - qe_f, n - qs_f) if rev else (qs_f, qe_f)
        name = self.genome.names[ctg]
        return make_record(read, name, self.contigs[name],
                           "-" if rev else "+", qs, qe, w0 + ws, w0 + we,
                           cigar, self.sc)

    # -------------------------------------------------------- the judge
    def judge(self, reads: Sequence[str], truths, records) -> Dict:
        """The numbers compared, over the sampled reads: `records[r]` is
        read r's list of records (run.program_record's tuples)."""
        best, _ = self._run(reads, truths)
        bad, gaps, worst = [], [], None
        for r, s in enumerate(reads):
            why, score = judge_read(records[r], encode(s), self.contigs,
                                    self.sc)
            if why is not None:
                bad.append((r, why))
                continue
            if truths[r] is None or best[r] <= 0:
                continue
            gap = 100.0 if score is None else \
                100.0 * (best[r] - score) / best[r]
            gaps.append(gap)
            if worst is None or gap > worst[1]:
                worst = (r, gap, score, best[r])
        return {"records_inconsistent": float(len(bad)),
                "score_gap_pct": max(gaps, default=0.0),
                "first_inconsistent": bad[:3], "widest_gap": worst,
                "judged": len(gaps)}

    def control_records(self, reads: Sequence[str], truths) -> List[list]:
        """The control's records: its bfloat16 DP's best path for each
        read drawn from the genome (none for the others)."""
        _, recs = self._run(reads, truths, rounding=dp.bf16, traceback=True,
                            block=CONTROL_BLOCK)
        return [recs.get(r, []) for r in range(len(reads))]

    # ------------------------------------------------- the kernels' work
    def kernel_work(self, reads: Sequence[str],
                    mult: Sequence[int]) -> Dict[str, float]:
        """The bytes and int32 operations kernels K1 and K2 need for
        `reads`, read r taken mult[r] times (portbench/roofline.py),
        from each read's plain anchor count."""
        n = anchors.anchors_by_read(reads, self.genome, self.cfg["seeding"],
                                    self.device).astype(np.float64)
        m = np.asarray(mult, np.float64)
        b1, o1 = roofline.k1_work(n)
        b2, o2 = roofline.k2_work(n, [len(s) for s in reads])
        return {"k1_bytes": float((m * b1).sum()),
                "k1_ops": float((m * o1).sum()),
                "k2_bytes": float((m * b2).sum()),
                "k2_ops": float((m * o2).sum()),
                "anchors": float((m * n).sum())}

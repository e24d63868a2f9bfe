"""Tiny runs of the benchmark's cells on the CPU for the tests: the
cell's own configuration and mix, cut to a 1 Mbp genome, a few dozen
reads and a few seconds."""
from __future__ import annotations

import json
import os
import time

from portbench import run

SEED = 3000000019  # above 2^31: seeds that large must work

#: cells whose configuration and mix are kept under portbench/ for a
#: later PR but which BENCHMARK.json does not hold (PERF.md, Open
#: questions): their files, and the end-to-end metrics their loops give
FILE_CELLS = {
    "ont-hg38.readfish": ("ont-hg38", "readfish",
                          [{"name": "read_p95_ms", "unit": "ms"},
                           {"name": "setup_s", "unit": "s"}]),
    "ont-ecoli.wgs": ("ont-ecoli", "wgs",
                      [{"name": "reads_per_s", "unit": "reads/s"},
                       {"name": "setup_s", "unit": "s"}]),
}


def cell_spec(workload: str) -> run.Spec:
    """The cell's spec, from BENCHMARK.json or from FILE_CELLS."""
    if workload not in FILE_CELLS:
        return run.load_spec(workload)
    config, traffic, e2e = FILE_CELLS[workload]
    with open(os.path.join(run.HERE, "configs", config + ".json")) as fh:
        cfg = json.load(fh)
    with open(os.path.join(run.HERE, "traffic", traffic + ".json")) as fh:
        mix = json.load(fh)
    cell = {"name": workload, "config": config, "traffic": traffic,
            "chips": 1}
    return run.Spec(cell, cfg, mix, e2e, [])


def tiny_spec(workload: str) -> run.Spec:
    spec = cell_spec(workload)
    spec.cfg.update(contigs=2, contig_len=1 << 19)
    if spec.mix["loop"] == "open":
        spec.mix.update(reads_per_s=30, warmup_batches=1, sample=12,
                        batch_reads=[16, 32])
    else:
        spec.mix.update(pool_reads=300, call_reads=100, warmup_reads=8,
                        sample=12)
        spec.mix["read"].update(median=600, min=300, max=2000)
    return spec


def tiny_run(workload: str, seconds: float = 3.0, trace: bool = False,
             mode: str = "run", seed: int = SEED, spec=None):
    spec = spec or tiny_spec(workload)
    # small device batches, so that the CPU returns reads inside seconds
    prev = os.environ.get("MAPPY_RS_TPU_BATCH")
    os.environ["MAPPY_RS_TPU_BATCH"] = "16"
    try:
        return run.run_cell(spec, seed, seconds, trace, "cpu",
                            time.perf_counter(), mode)
    finally:
        if prev is None:
            del os.environ["MAPPY_RS_TPU_BATCH"]
        else:
            os.environ["MAPPY_RS_TPU_BATCH"] = prev

"""The port's thread table, memory soak and microbenchmarks
(mappy_rs_tpu_torch/tools/thread_bench.py, memory.py, microbench.py) on
the CPU.

(a) thread_bench draws the reads tests/benchmark.py draws (loaded by
    path) from the same seed, and its table has the four rows with equal
    mapped counts;
(b) the memory soak draws tests/memory.py's genome and reads, and exits
    0 over 4 cycles, the Mappings equal in every cycle;
(c) microbench --device cpu runs its front-end part (the card's parts
    skip without a card).
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from mappy_rs_tpu_torch.tools import memory, microbench, thread_bench

# one intra-op thread per test process: the suite runs several pytest
# workers at once, and torch's default (a thread per core in each)
# oversubscribes the cores many times over
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_thread_bench_reads_match_tests_benchmark():
    ref = _load("ref_benchmark", os.path.join("tests", "benchmark.py"))
    genome, reads = thread_bench.data(24, 1000)
    # tests/benchmark.py main's construction
    rng = np.random.default_rng(0)
    want_genome = "".join(rng.choice(list("ACGT"), size=500_000))
    assert genome == want_genome
    assert reads == ref.simulate(rng, want_genome, 24, 1000)
    # and its simulate alone, on another seed, length and error rate
    a = thread_bench.simulate(np.random.default_rng(3), genome, 8, 300, 0.1)
    b = ref.simulate(np.random.default_rng(3), genome, 8, 300, 0.1)
    assert a == b and all(isinstance(r, str) for r in a)


def test_thread_bench_table(capsys):
    rec = thread_bench.run(32, 1000, device="cpu")
    rows = rec["rows"]
    assert [r[0] for r in rows] == [
        "map() loop, single-threaded", "map_batch, 1 thread(s)",
        "map_batch, 2 thread(s)", "map_batch, 4 thread(s)"]
    assert {r[2] for r in rows} == {32}
    thread_bench.report(rec)
    assert "map_batch, 4 thread(s)" in capsys.readouterr().out


def test_memory_soak_data_matches_tests_memory():
    genome, reads = memory.data()
    # tests/memory.py main's construction
    rng = np.random.default_rng(0)
    want = "".join(rng.choice(list("ACGT"), size=100_000))
    assert genome == want
    assert reads == [want[int(p): int(p) + 500]
                     for p in rng.integers(0, len(want) - 500, 50)]


@pytest.mark.parametrize("mode", [["--threaded"], ["--no-op"]])
def test_memory_soak_exits_zero(tmp_path, mode, capsys):
    out = tmp_path / "m.json"
    rc = memory.main(mode + ["--cycles", "4", "--device", "cpu",
                             "--out", str(out)])
    with open(out) as fh:
        rec = json.load(fh)
    assert rc == 0, rec
    assert rec["digests_equal"] and rec["failed"] == []
    assert [ln["cycle"] for ln in rec["lines"]] == [0, 3]
    assert rec["rss_growth_mb"] is not None and rec["cuda_growth_mb"] is None
    assert rec["max_rss_growth_mb"] is not None
    assert all(ln["rss_mb"] > 0 for ln in rec["lines"])
    assert "rss growth after warm-up" in capsys.readouterr().out


def test_memory_check_flags_growth_and_changed_mappings():
    rec = {"max_rss_growth_mb": 0.0, "rss_growth_mb": 250.0,
           "digests_equal": False,
           "cuda_growth_mb": {"allocated": 10.0, "reserved": 300.0}}
    bad = memory.check(rec)
    assert len(bad) == 3 and "rss grew" in bad[0] and "reserved" in bad[1]
    assert memory.check({"max_rss_growth_mb": 201.0, "rss_growth_mb": 1.0,
                         "digests_equal": True, "cuda_growth_mb": None}) \
        == ["max_rss grew 201.0 MB"]
    assert memory.check({"max_rss_growth_mb": 0.0, "rss_growth_mb": 1.0,
                         "digests_equal": True, "cuda_growth_mb": None}) == []


def test_memory_current_rss_tracks_allocation():
    """The resident set now rises with a fresh allocation, as the peak
    does only when it is above every earlier peak."""
    before = memory.rss_mb()
    block = np.ones(64 * 2**20 // 8)  # 64 MiB, touched
    assert memory.rss_mb() - before > 48
    assert memory.max_rss_mb() >= memory.rss_mb() > 0
    del block


def test_microbench_front_end_on_cpu(capsys):
    rec = microbench.run("cpu", 1)
    assert "dispatch_ms" not in rec and "download" not in rec
    fe = rec["front_end"]
    for key in ("compute_only_ms", "compute_download_ms"):
        assert 0 < fe[key]["min"] <= fe[key]["med"]
    assert fe["metrics"]["fe_batches"] == 1 and fe["metrics"]["reads"] == 256
    text = capsys.readouterr().out
    assert "front_end compute only" in text and "no card" in text

"""The port's bench (mappy_rs_tpu_torch/tools/bench.py), held against the
repo's bench.py and the JAX package on the CPU.

(a) the workload (genome, reads, origins, payloads, the baseline's
    fingerprint) is byte-equal to bench.py's construction from the same
    seed (bench.py loaded by path: its top level imports only numpy and
    the standard library);
(b) the card path's configuration (map-ont, "device_owner", 3
    children, proc_chunk 512) and the CPU baseline's (native front end,
    host extension, device="cpu") give the JAX package's Mappings on 64
    reads of a 2 Mbp workload;
(c) a --baseline-file is reused only when its workload fingerprint and
    n_cores match;
(d) the tool end to end at 1 Mbp (2 passes of 256 reads, a 128-read
    baseline, "device_owner" with 2 children, on 2 CPUs): one JSON line
    with bench.py's keys, every read placed, a baseline file of another
    n_cores measured anew, BASELINE_CPU.json untouched.
"""
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mappy_rs_tpu

from mappy_rs_tpu_torch.tools import bench

from torch_parity import same_mappings

# one intra-op thread per test process: the suite runs several pytest
# workers at once, and torch's default (a thread per core in each)
# oversubscribes the cores many times over
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_KNOBS = ("MAPPY_RS_TPU_TOPOLOGY", "MAPPY_RS_TPU_PROCS",
             "MAPPY_RS_TPU_PROC_CHUNK", "MAPPY_RS_TPU_PROXIES",
             "MAPPY_RS_TPU_FRONT_END", "MAPPY_RS_TPU_EXTENSION")


@pytest.fixture(scope="module")
def jax_bench():
    """The repo's bench.py, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def clean_env(monkeypatch):
    for name in ENV_KNOBS:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def wl2():
    """64 reads of the bench workload at 2 Mbp."""
    return bench.workload(2, 64, 1, 64)


def test_workload_matches_bench_py(jax_bench):
    n_reads, n_pass, n_cpu = 64, 2, 32
    wl = bench.workload(1, n_reads, n_pass, n_cpu)
    # bench.py _run's construction, at 1 Mbp and these counts
    rng = np.random.default_rng(0)
    genome = bytes(
        np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 1_000_000)]
    ).decode()
    reads, truth = jax_bench.simulate(rng, genome, n_pass * n_reads,
                                      jax_bench.READ_LEN, jax_bench.ERROR_RATE)
    payload = [{"i": i, "seq": r} for i, r in enumerate(reads)]
    assert wl.genome == genome
    assert wl.reads == reads and wl.truth == truth
    assert wl.payloads == [payload[p * n_reads:(p + 1) * n_reads]
                           for p in range(n_pass)]
    assert wl.cpu_payloads == [payload[p * n_reads:p * n_reads + n_cpu]
                               for p in range(n_pass)]
    # bench.py's defaults and its baseline fingerprint
    assert (bench.N_READS, bench.N_READS_CPU, bench.READ_LEN,
            bench.ERROR_RATE) == (jax_bench.N_READS, jax_bench.N_READS_CPU,
                                  jax_bench.READ_LEN, jax_bench.ERROR_RATE)
    full = bench.Workload(jax_bench.GENOME_MB, "", [], [], [],
                          [[None] * jax_bench.N_READS_CPU])
    assert full.fingerprint == jax_bench._workload_fp()
    with pytest.raises(ValueError, match="baseline reads"):
        bench.workload(1, 64, 1, 65)


def test_card_path_config_matches_jax(wl2, clean_env):
    tal = bench.card_aligner(wl2.genome, "cpu")
    cfg = tal._config
    assert (cfg.topology, cfg.worker_processes, cfg.proc_chunk) == (
        "device_owner", 3, 512)
    assert (cfg.front_end_backend, tal._engine.device.type) == ("device",
                                                                 "cpu")
    jal = mappy_rs_tpu.Aligner(seq=wl2.genome, preset="map-ont")
    got = same_mappings(tal, jal, wl2.reads)
    placed = sum(1 for ms, s in zip(got, wl2.truth)
                 if ms and abs(ms[0][5] - s) < 100)
    assert placed == len(wl2.reads)


def test_baseline_config_matches_jax(wl2, clean_env):
    tal = bench.cpu_aligner(wl2.genome)
    assert (tal._config.front_end_backend, tal._config.extension_backend,
            tal._config.topology) == ("cpu", "host", "classic")
    jal = mappy_rs_tpu.Aligner(seq=wl2.genome, preset="map-ont")
    jal._engine.cfg.front_end_backend = "cpu"
    jal._engine.cfg.extension_backend = "host"
    same_mappings(tal, jal, wl2.reads)


@pytest.mark.parametrize("case", ["match", "workload", "n_cores", "missing",
                                  "unreadable", "forced"])
def test_baseline_file_reused_only_when_it_matches(tmp_path, monkeypatch,
                                                   case):
    wl = bench.Workload(1, "", [], [], [], [[None] * 128])
    n_cores = len(os.sched_getaffinity(0))
    stored = {"value": 12345.0, "date": "stored", "desc": "",
              "n_cores": n_cores, "workload": wl.fingerprint}
    if case == "workload":
        stored["workload"] = dict(wl.fingerprint, genome_mb=2)
    elif case == "n_cores":
        stored["n_cores"] = n_cores + 1
    path = tmp_path / "b.json"
    if case == "unreadable":
        path.write_text("{not json")
    elif case != "missing":
        path.write_text(json.dumps(stored))
    measured = {"value": 1.0, "date": "now", "desc": "", "n_cores": n_cores,
                "modes": {},
                "workload": wl.fingerprint}
    monkeypatch.setattr(bench, "measure_cpu_baseline", lambda w: measured)
    got = bench.baseline_for(wl, str(path), force=case == "forced")
    if case == "match":
        assert got == stored
        assert json.loads(path.read_text()) == stored
    else:
        assert got is measured
        assert json.loads(path.read_text()) == measured


def _digest(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def test_bench_end_to_end(tmp_path, jax_bench):
    cpus = sorted(os.sched_getaffinity(0))[:2]
    base_file = tmp_path / "baseline.json"
    wl = bench.Workload(1, "", [], [], [], [[None] * 128])
    base_file.write_text(json.dumps(
        {"value": 12345.0, "date": "stored", "desc": "",
         "n_cores": len(cpus) + 1, "workload": wl.fingerprint}))
    frozen = os.path.join(ROOT, "BASELINE_CPU.json")
    before = _digest(frozen)
    out = tmp_path / "rec.json"
    env = {k: v for k, v in os.environ.items() if k not in ENV_KNOBS}
    env.update(OMP_NUM_THREADS="1", MAPPY_RS_TPU_PROCS="2",
               PYTHONPATH=ROOT)
    argv = [sys.executable, "-m", "mappy_rs_tpu_torch.tools.bench",
            "--genome-mb=1", "--reads=256", "--passes=2", "--cpu-reads=128",
            "--device=cpu", f"--baseline-file={base_file}", f"--out={out}"]
    # pinned to 2 CPUs (inherited across exec), so n_cores is 2
    pin = (f"import os, sys; os.sched_setaffinity(0, {cpus!r}); "
           f"os.execv(sys.executable, {argv!r})")
    res = subprocess.run([sys.executable, "-c", pin], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [ln for ln in res.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, res.stdout
    line = json.loads(lines[0])
    # bench.py's keys (bench.py _run's json.dumps) plus "card"
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "passes",
                         "median", "best", "baseline", "card"}
    assert {"value", "date", "desc"} <= set(line["baseline"])
    assert line["card"] is None and len(line["passes"]) == 2
    assert line["baseline"]["value"] != 12345.0  # measured anew
    assert line["baseline"]["n_cores"] == len(cpus)
    assert line["vs_baseline"] == round(line["median"] /
                                        line["baseline"]["value"], 3)
    with open(out) as fh:
        rec = json.load(fh)
    assert [p["placed"] for p in rec["passes"]] == [256, 256]
    assert rec["run"]["topology"] == "device_owner"
    assert rec["run"]["procs"] == 2 and rec["run"]["proxies"] == 6
    # no graph off the card: every front-end batch ran eagerly
    assert rec["fe_graphs"]["replays"] == 0
    assert rec["fe_graphs"]["fe_batches"] > 0
    assert set(rec["baseline"]["modes"]) == {f"{len(cpus)} threads",
                                             f"{len(cpus)} procs"}
    stored = json.loads(base_file.read_text())
    assert stored["n_cores"] == len(cpus)
    assert stored["workload"] == wl.fingerprint
    assert stored["value"] == line["baseline"]["value"]
    assert "# accuracy: 256/256 within 100bp" in res.stderr
    assert _digest(frozen) == before

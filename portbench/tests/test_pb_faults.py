"""A run of the benchmark's cell with the timed path broken underneath
comes out not correct: an answer altered where it is produced (a
record's target start moved by one base), half of each device batch
left out (mapped as nothing), and a batch whose reads never come
back."""
import contextlib

import pytest

from mappy_rs_tpu_torch import api
from portbench import loops
from portbench.tests.tiny import tiny_run


@contextlib.contextmanager
def _patched(name, make):
    orig = getattr(api.Aligner, name)
    fn = make(orig)
    setattr(api.Aligner, name, fn)
    try:
        yield
    finally:
        setattr(api.Aligner, name, orig)
        getattr(fn, "restore", lambda: None)()


def _altered(orig):
    def f(self, regions):
        out = orig(self, regions)
        for m in out[:1]:
            m.target_start += 1
        return out
    return f


def _half_left_out(orig):
    def f(self, seqs):
        out = orig(self, seqs)
        return out[: len(out) - len(out) // 2] + [[]] * (len(out) // 2)
    return f


def _batch_lost(orig):
    seen = {"window_calls": 0}
    orig_reset = api.Aligner.reset_metrics

    def reset(self):  # the harness resets the counters after the warm-up
        seen["armed"] = True
        orig_reset(self)

    api.Aligner.reset_metrics = reset

    def f(self, seqs):
        if seen.get("armed"):
            seen["window_calls"] += 1
            if seen["window_calls"] == 2:
                raise RuntimeError("planted fault")
        return orig(self, seqs)
    f.restore = lambda: setattr(api.Aligner, "reset_metrics", orig_reset)
    return f


@pytest.mark.parametrize("name,make,check", [
    ("_to_mappings", _altered, "records_inconsistent"),
    ("_threaded_map", _half_left_out, "score_gap_pct"),
    ("_threaded_map", _batch_lost, "reads_lost"),
])
def test_fault_is_not_correct(name, make, check, monkeypatch):
    if check == "reads_lost":  # wait less for the reads that never come
        monkeypatch.setattr(loops, "DRAIN_S", 20.0)
    with _patched(name, make):
        res = tiny_run("ont-ecoli.wgs-8k", seconds=20.0)
    assert res["correct"] is False
    c = res["checks"][check]
    assert c["value"] > c["limit"]

"""The port's spans and the workers' timeline (mappy_rs_tpu_torch/
utils/metrics.py) on the CPU: the sums that the stage timers gave, each
thread's states that never overlap, the bounded buffer, the events'
format and clock, and a threaded map_batch that fills the states."""
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

import mappy_rs_tpu_torch
from mappy_rs_tpu_torch.utils import metrics as metrics_mod
from mappy_rs_tpu_torch.utils.metrics import STATES, EngineMetrics
from mappy_rs_tpu_torch.utils.simulate import random_genome, simulate

# one intra-op thread per test process: the suite runs several pytest
# workers at once, and torch's default (a thread per core in each)
# oversubscribes the cores many times over
torch.set_num_threads(1)


def _busy(seconds: float) -> None:
    t = time.perf_counter() + seconds
    while time.perf_counter() < t:
        pass


def _by_thread(events):
    out = {}
    for e in events:
        out.setdefault(e["tid"], []).append(e)
    return out


def _metrics(timeline: bool = True) -> EngineMetrics:
    m = EngineMetrics()
    m.set_timeline(timeline)
    return m


def _no_overlap(events) -> None:
    """Each thread's events are disjoint (to the 0.25 µs that a float
    holds of a Unix time in µs)."""
    for evs in _by_thread(events).values():
        evs = sorted(evs, key=lambda e: e["ts"])
        for a, b in zip(evs, evs[1:]):
            assert a["ts"] + a["dur"] <= b["ts"] + 0.5, (a, b)


@pytest.mark.parametrize("name,timeline", [
    ("map_batch", False), ("post_chain", False), ("map_batch", True)])
def test_span_keeps_the_timer_sums(name, timeline):
    """A span sums thread seconds and calls under the stage timer's keys
    (``time_<name>_s``, ``calls_<name>``) and no others, state or not,
    timeline on or off: a busy block and a sleep alike."""
    m = _metrics(timeline)
    t0 = time.perf_counter()
    with m.span(name):
        _busy(0.03)
    with m.span(name):
        time.sleep(0.03)
    wall = time.perf_counter() - t0
    snap = {k: v for k, v in m.snapshot().items() if k != "timeline_dropped"}
    assert set(snap) == {f"time_{name}_s", f"calls_{name}"}
    assert snap[f"calls_{name}"] == 2
    assert 0.06 <= snap[f"time_{name}_s"] <= wall + 1e-4
    m.reset()
    assert m.snapshot() == ({"timeline_dropped": 0} if timeline else {})


def test_a_span_is_reused_and_nests_under_its_own_name():
    """One span object per name and thread, entered again for each use;
    the same name opened inside itself gets one of its own, and both
    are summed."""
    m = EngineMetrics()
    a = m.span("extend")
    assert m.span("extend") is a and m.span("finalize") is not a
    with m.span("extend") as outer:
        assert outer is a
        with m.span("extend") as inner:
            assert inner is not a
            _busy(0.01)
    assert m.span("extend") is a
    s = m.snapshot()
    assert s["calls_extend"] == 2 and s["time_extend_s"] >= 0.02
    seen = []
    t = threading.Thread(target=lambda: seen.append(m.span("extend")))
    t.start()
    t.join()
    assert seen[0] is not a


def test_sums_only_spans_nest_inclusively_and_states_exclusively():
    """``front_end`` around a state sums all of it; a state inside a
    state pauses the outer one, whose sum leaves it out."""
    m = _metrics()
    with m.span("front_end"), m.span("fe_submit"):
        _busy(0.02)
        with m.span("graph_capture"):
            _busy(0.03)
        _busy(0.01)
    s = m.snapshot()
    assert s["time_front_end_s"] >= 0.06
    assert 0.03 <= s["time_graph_capture_s"] < 0.05
    assert 0.03 <= s["time_fe_submit_s"] < 0.05
    assert s["time_fe_submit_s"] + s["time_graph_capture_s"] == \
        pytest.approx(s["time_front_end_s"], abs=2e-3)


def test_timeline_off_records_nothing():
    m = EngineMetrics()
    assert m.timeline is False
    for name in sorted(STATES) + ["map_batch"]:
        with m.span(name):
            pass
    assert m.span_events() == []
    assert "timeline_dropped" not in m.snapshot()
    assert all(line.buf is None for line in m._lines)


def test_buffer_keeps_its_bound_and_counts_drops(monkeypatch):
    monkeypatch.setattr(metrics_mod, "TIMELINE_RECORDS", 5)
    m = _metrics()
    for i in range(12):
        with m.span("post_chain" if i % 2 else "finalize"):
            _busy(1e-4)
    ev = m.span_events()
    assert len(ev) == 5
    assert m.snapshot()["timeline_dropped"] == 7
    # the oldest went: the last five remain, in order
    assert [e["name"] for e in ev] == ["post_chain", "finalize",
                                       "post_chain", "finalize",
                                       "post_chain"]
    m.reset()
    assert m.span_events() == [] and m.snapshot()["timeline_dropped"] == 0
    m.set_timeline(False)
    assert m.span_events() == [] and "timeline_dropped" not in m.snapshot()


def test_states_on_one_thread_never_overlap():
    """States nested in states, inside sums-only spans, on four threads:
    each thread's events are disjoint, an outer state resumes after an
    inner one, and the events sum to the states' sums."""
    m = _metrics()

    def work():
        for _ in range(3):
            with m.span("map_batch"):
                with m.span("fe_submit"):
                    _busy(1e-3)
                    with m.span("graph_capture"):
                        _busy(1e-3)
                    _busy(1e-3)
                with m.span("post_chain_py"):
                    with m.span("extend"):
                        _busy(1e-3)
                    with m.span("finalize"):
                        _busy(1e-3)
                with m.span("queue_wait"):
                    time.sleep(1e-3)

    ts = [threading.Thread(target=work) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    ev = m.span_events()
    _no_overlap(ev)
    by = _by_thread(ev)
    assert len(by) == 4
    for evs in by.values():
        names = [e["name"] for e in evs]
        assert names[:7] == ["fe_submit", "graph_capture", "fe_submit",
                             "post_chain_py", "finalize", "post_chain_py",
                             "queue_wait"]
        assert "map_batch" not in names and "extend" not in names
    s = m.snapshot()
    assert s["calls_fe_submit"] == 12 and s["calls_graph_capture"] == 12
    # the events sum to the states' (exclusive) sums
    for name in ("fe_submit", "graph_capture", "post_chain_py", "finalize"):
        got = sum(e["dur"] for e in ev if e["name"] == name) / 1e6
        assert got == pytest.approx(s[f"time_{name}_s"], abs=1e-3)


def test_threads_lose_no_span(monkeypatch):
    """Sixteen threads, more than the cores, switching every microsecond,
    while the main thread reads snapshots: every span is summed once."""
    monkeypatch.setattr(metrics_mod, "TIMELINE_RECORDS", 64)
    m = _metrics()
    n = 2000

    def work():
        for i in range(n):
            with m.span("post_chain" if i % 2 else "map_batch"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work) for _ in range(16)]
        for t in ts:
            t.start()
        while any(t.is_alive() for t in ts):
            m.snapshot()
            m.span_events()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    s = m.snapshot()
    assert s["calls_post_chain"] == s["calls_map_batch"] == 16 * n // 2
    assert s["timeline_dropped"] == 16 * (n // 2 - 64)


def test_event_format():
    m = _metrics()
    with m.span("epoch_wait"):
        time.sleep(2e-3)
    (e,) = m.span_events()
    assert set(e) == {"ph", "cat", "name", "pid", "tid", "ts", "dur", "args"}
    assert e["ph"] == "X" and e["cat"] == "user_annotation"
    assert e["name"] == "epoch_wait"
    assert e["tid"] == threading.get_native_id()
    assert e["args"] == {"thread": threading.current_thread().name}
    assert 2e3 <= e["dur"] < 1e5  # µs
    # ts + base / 1e3 is Unix time in µs
    now_us = time.time_ns() / 1e3
    assert now_us - 1e6 < e["ts"] < now_us
    base = 1_700_000_000 * 10**9
    (e2,) = m.span_events(base)
    assert e2["ts"] + base / 1e3 == pytest.approx(e["ts"], abs=1.0)
    json.dumps(e)


def test_clock_matches_the_profilers(tmp_path):
    """A span around a record_function block, under the CPU profiler:
    once merged into the exported trace, the two overlap to within
    1 ms at both ends."""
    from torch.profiler import ProfilerActivity, profile, record_function

    m = _metrics()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            pass
        with m.span("post_chain"), record_function("block"):
            time.sleep(0.02)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    trace["traceEvents"] += m.span_events(
        int(trace.get("baseTimeNanoseconds", 0)))
    (blk,) = [e for e in trace["traceEvents"] if e.get("name") == "block"]
    (sp,) = [e for e in trace["traceEvents"] if e.get("name") == "post_chain"]
    assert abs(sp["ts"] - float(blk["ts"])) < 1e3
    assert abs(sp["ts"] + sp["dur"] - float(blk["ts"]) - float(blk["dur"])) \
        < 1e3


@pytest.fixture(scope="module")
def workload():
    rng = np.random.default_rng(11)
    g = random_genome(rng, 300_000)
    reads, starts = simulate(rng, g, 96, 1000, 0.05)
    return g, reads, starts


def test_threaded_map_batch_fills_the_states(workload, monkeypatch):
    """Aligner.enable_timeline switches the timeline on; two threaded
    calls fill the waits, the front end's states and the post-chain, on
    the workers' threads only, with no two states of a thread at once."""
    g, reads, starts = workload
    monkeypatch.setenv("MAPPY_RS_TPU_BATCH", "32")
    al = mappy_rs_tpu_torch.Aligner(seq=g, device="cpu")
    al.enable_timeline()
    assert al._engine.metrics.timeline is True
    al.enable_threading(2)
    try:
        payload = [{"i": i, "seq": s} for i, s in enumerate(reads)]
        al.reset_metrics()
        for _ in range(2):
            for ms, d in al.map_batch(payload):
                assert abs(ms[0].target_start - starts[d["i"]]) < 100
        # the last worker's barrier may end just after the iterator does
        t = time.perf_counter() + 10.0
        while (al.metrics.get("calls_epoch_wait", 0) < 2 * 2
               and time.perf_counter() < t):
            time.sleep(0.01)
    finally:
        al.enable_threading(0)
    m = al.metrics
    for name in ("queue_wait", "epoch_wait", "post_chain", "finalize",
                 "fe_stage", "fe_submit", "fe_wait"):
        assert m.get(f"calls_{name}", 0) > 0, name
    # the native call's own CPU seconds, within its span's
    assert 0 < m["cpu_post_chain_s"] <= 1.05 * m["time_post_chain_s"]
    assert not [k for k in m if k.startswith("cpu_") and k !=
                "cpu_post_chain_s"]
    assert m["calls_epoch_wait"] == 2 * 2  # a pill per worker per call
    assert m["timeline_dropped"] == 0
    for gone in ("reads_per_sec", "dp_cells_per_sec", "fe_reads"):
        assert gone not in m
    ev = al.span_events()
    assert {e["name"] for e in ev} >= {"queue_wait", "epoch_wait",
                                       "post_chain", "fe_submit"}
    assert {e["name"] for e in ev} <= STATES
    names = {e["args"]["thread"] for e in ev}
    assert names and all("_worker_loop" in n for n in names)
    _no_overlap(ev)


def test_aligner_timeline_is_off_by_default(workload):
    g, reads, _ = workload
    al = mappy_rs_tpu_torch.Aligner(seq=g, device="cpu")
    al.map(reads[0])
    assert al.span_events() == []
    assert al.metrics["calls_post_chain"] == 1
    al.enable_timeline()
    al.map(reads[1])
    assert {e["name"] for e in al.span_events()} >= {"post_chain"}
    al.enable_timeline(False)
    assert al.span_events() == []


def test_a_span_open_at_reset_is_not_summed():
    """A wait that began before reset_metrics brings none of its time
    into the sums; its record still enters the timeline."""
    m = _metrics()
    go = threading.Event()

    def wait():
        with m.span("queue_wait"):
            go.wait()

    t = threading.Thread(target=wait)
    t.start()
    time.sleep(0.02)
    m.reset()
    with m.span("post_chain"):
        pass
    go.set()
    t.join()
    s = m.snapshot()
    assert "calls_queue_wait" not in s and s["calls_post_chain"] == 1
    assert {e["name"] for e in m.span_events()} == {"queue_wait",
                                                    "post_chain"}


@pytest.mark.parametrize("name", ["post_chain", "map_batch"])
def test_a_stage_open_at_reset_is_summed_whole(name):
    """A stage (not a wait) that began before reset_metrics is summed
    whole when it ends, as the stage timers were; what ended before the
    reset is gone."""
    m = EngineMetrics()
    with m.span(name):
        pass
    go = threading.Event()

    def stage():
        with m.span(name):
            go.wait()

    t = threading.Thread(target=stage)
    t.start()
    time.sleep(0.02)
    m.reset()
    assert m.snapshot() == {}
    go.set()
    t.join()
    s = m.snapshot()
    assert s[f"calls_{name}"] == 1 and s[f"time_{name}_s"] >= 0.02


def test_native_post_chain_times_its_cpu(workload):
    """The native post-chain call returns its thread CPU seconds: more
    than none, and no more than the call's own thread seconds."""
    from mappy_rs_tpu_torch import native

    if not native.available():
        pytest.skip("native library unavailable")
    g, reads, _ = workload
    al = mappy_rs_tpu_torch.Aligner(seq=g, device="cpu")
    al.reset_metrics()
    for r in reads[:32]:
        al.map(r)
    m = al.metrics
    assert m["calls_post_chain"] == 32
    assert 0 < m["cpu_post_chain_s"] <= m["time_post_chain_s"] + 1e-3

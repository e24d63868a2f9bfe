"""The readers of the engine's worker-state spans (portbench/metrics/
fe_wait_ms_per_batch.py, fe_host_ms_per_batch.py, worker_wait_pct.py,
post_chain_cpu_pct.py) on hand-made counters: the documented values,
and None where the counts are zero or the program keeps no such span
(a program without the spans)."""
import pytest

from portbench import run, trace

COUNTERS = {
    "fe_batches": 40.0, "reads": 10_240.0,
    "time_fe_stage_s": 0.2, "calls_fe_stage": 40,
    "time_fe_submit_s": 0.6, "calls_fe_submit": 40,
    "time_fe_wait_s": 1.0, "calls_fe_wait": 40,
    "time_fe_host_bt_s": 0.0, "calls_fe_host_bt": 0,
    "time_queue_wait_s": 3.0, "calls_queue_wait": 9,
    "time_epoch_wait_s": 2.0, "calls_epoch_wait": 8,
    "time_result_wait_s": 0.0, "calls_result_wait": 0,
    "time_graph_capture_s": 0.0,
    "time_post_chain_s": 10.0, "cpu_post_chain_s": 9.0,
    "calls_post_chain": 40,
    "time_finalize_s": 1.2, "calls_finalize": 40,
    "time_post_chain_py_s": 0.0,
    # sums only, not states: left out of the workers' time
    "time_front_end_s": 1.9, "time_extend_s": 10.0, "time_map_batch_s": 19.0,
}


def _m(counters):
    return run.Measured("ont-ecoli.wgs-8k", {}, {}, None, 0.0, counters, {})


@pytest.mark.parametrize("name,want", [
    ("fe_wait_ms_per_batch.rate", 1e3 * 1.0 / 40),
    ("fe_host_ms_per_batch.rate", 1e3 * (0.2 + 0.6 + 0.0) / 40),
    # states: 0.2 + 0.6 + 1.0 + 3.0 + 2.0 + 10.0 + 1.2 = 18.0 s
    ("worker_wait_pct.rate", 100.0 * 5.0 / 18.0),
    ("post_chain_cpu_pct.rate", 90.0),
])
def test_documented_values(name, want):
    assert run.reader(name).read(_m(dict(COUNTERS))) == pytest.approx(want)


@pytest.mark.parametrize("name,zero", [
    ("fe_wait_ms_per_batch.rate", ("fe_batches",)),
    ("fe_wait_ms_per_batch.rate", ("calls_fe_wait",)),
    ("fe_host_ms_per_batch.rate", ("fe_batches",)),
    ("fe_host_ms_per_batch.rate", ("calls_fe_submit",)),
    ("worker_wait_pct.rate", ("calls_queue_wait", "calls_epoch_wait")),
    ("post_chain_cpu_pct.rate", ("time_post_chain_s",)),
])
def test_none_when_the_counts_are_zero(name, zero):
    c = dict(COUNTERS)
    for k in zero:
        c[k] = 0
    assert run.reader(name).read(_m(c)) is None


@pytest.mark.parametrize("name", ["fe_wait_ms_per_batch.rate",
                                  "fe_host_ms_per_batch.rate",
                                  "worker_wait_pct.rate",
                                  "post_chain_cpu_pct.rate"])
def test_none_without_the_spans(name):
    """A program with the stage timers and no worker-state spans."""
    old = {"fe_batches": 40.0, "reads": 10_240.0, "time_front_end_s": 1.9,
           "calls_front_end": 80, "time_extend_s": 10.0, "calls_extend": 40,
           "time_finalize_s": 1.2, "calls_finalize": 40}
    assert run.reader(name).read(_m(old)) is None
    assert run.reader(name).read(_m({})) is None


def test_span_events_name_the_gaps():
    """The span events, appended to a trace of CUDA activity, name its
    idle gaps in the unchanged trace.summarize: the longest covering
    host event is a worker's state."""
    ev = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 0.0, "dur": 10.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 1.0, "dur": 2.0},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 500.0, "dur": 10.0},
          {"ph": "X", "cat": "user_annotation", "name": "post_chain",
           "ts": 5.0, "dur": 400.0, "tid": 2},
          {"ph": "X", "cat": "user_annotation", "name": "epoch_wait",
           "ts": 200.0, "dur": 100.0, "tid": 3}]
    s = trace.summarize({"traceEvents": ev}, 0.0, 510.0)
    assert s["idle_gaps"][0] == ["post_chain", pytest.approx(490e-6)]

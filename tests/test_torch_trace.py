"""The port's front-end trace tool (mappy_rs_tpu_torch/tools/
trace_front_end.py) on the CPU.

``parse_trace`` / ``summarize`` on small Chrome-trace dicts of the
layout ``torch.profiler`` exports: device work (kernels, copies,
memsets) summed into busy time, device-side annotation spans (the
envelopes of that work) listed by name but kept out of the sum, duty =
busy / wall, and null device fields when the trace holds no kernel.
Then the tool's ``main`` at a small size on the CPU with the host
profile: every device field null, the host part filled.
"""
import json

import pytest
import torch

from mappy_rs_tpu_torch.tools import trace_front_end as tfe

# one intra-op thread per test process: the suite runs several pytest
# workers at once, and torch's default (a thread per core in each)
# oversubscribes the cores many times over
torch.set_num_threads(1)


def _ev(name, cat, ts, dur, ph="X"):
    return {"ph": ph, "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7}


TRACE = {"traceEvents": [
    _ev("ProfilerStep", "user_annotation", 0, 5000),        # host side
    _ev("cudaLaunchKernel", "cuda_runtime", 10, 5),          # host side
    _ev("front_end", "gpu_user_annotation", 100, 400),       # envelope
    _ev("chain_dp_kernel", "kernel", 100, 150),
    _ev("backtrack_kernel", "kernel", 260, 40),
    _ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 310, 10),
    _ev("Memset (Device)", "gpu_memset", 330, 2),
    _ev("chain_dp_kernel", "kernel", 1100, 150),
    _ev("backtrack_kernel", "kernel", 1260, 40),
    _ev("chain_dp_kernel", "kernel", 1300, 1, ph="i"),      # not a span
]}


def test_parse_trace_sums_device_work_and_skips_envelopes():
    by_name, busy, span, n_kernels = tfe.parse_trace(TRACE)
    assert busy == 150 + 40 + 10 + 2 + 150 + 40
    assert n_kernels == 4
    assert span == 1300 - 100
    assert by_name["chain_dp_kernel"] == 300
    assert by_name["front_end"] == 400  # listed, not summed
    assert "cudaLaunchKernel" not in by_name
    assert "ProfilerStep" not in by_name


def test_summarize_gives_duty_and_top_ops():
    s = tfe.summarize(TRACE, n=2, wall_s=0.01, top=3)
    assert s["profiler_device_events"] is True
    assert s["busy_ms_per_batch"] == pytest.approx(0.196)
    assert s["duty"] == pytest.approx(392e-6 / 0.01)
    assert s["span_ms_per_batch"] == pytest.approx(0.6)
    assert [n for n, _ in s["top_ops"]] == [
        "front_end", "chain_dp_kernel", "backtrack_kernel"]
    assert s["top_ops"][1][1] == pytest.approx(0.15)
    assert s["op_names"] == sorted(
        ["front_end", "chain_dp_kernel", "backtrack_kernel",
         "Memcpy HtoD (Pinned -> Device)", "Memset (Device)"])


def test_summarize_without_kernel_events_is_null():
    host_only = {"traceEvents": [e for e in TRACE["traceEvents"]
                                 if e["cat"] in ("user_annotation",
                                                 "cuda_runtime")]}
    for trace in (host_only, {"traceEvents": []}, {}):
        s = tfe.summarize(trace, n=2, wall_s=0.01)
        assert s == {"profiler_device_events": False,
                     "busy_ms_per_batch": None, "duty": None,
                     "span_ms_per_batch": None, "top_ops": None,
                     "op_names": None}


def test_main_on_the_cpu_with_host_profile(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("MAPPY_RS_TPU_BATCH", "32")  # B = 32 at L = 1024
    out = tmp_path / "trace.json"
    assert tfe.main(["2", "--device", "cpu", "--genome-len", "300000",
                     "--reads", "64", "--host-profile",
                     "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert rec["device"] == "cpu" and rec["replays"] == 2
    assert rec["shape"] == {"B": 32, "L": 1024, "M": 204, "A": 256}
    for name in ("profiler_device_events", "busy_ms_per_batch", "duty",
                 "span_ms_per_batch", "top_ops", "op_names",
                 "event_ms_per_batch",
                 "graph_ms_per_batch", "graph"):
        assert rec[name] is None, name
    assert rec["wall_ms_per_batch"] > 0 and min(rec["probe_ms"]) > 0
    host = rec["host"]
    assert host["serial_metrics"]["fe_batches"] == 2
    assert host["serial_metrics"]["reads"] == 64
    assert host["threads4_reads_per_s"] > 0
    assert host["serial_front_end_ms_per_batch"] > 0
    assert "front_end_bt" in host["cprofile_top"]

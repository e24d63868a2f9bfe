"""Share of the worker threads' time spent waiting, in %: the engine's
``queue_wait`` (the work queue empty), ``epoch_wait`` (the barrier after
a call's Done pill) and ``result_wait`` (the results queue full) spans
over the sum of every worker-state span (mappy_rs_tpu_torch/utils/
metrics.py ``STATES``), thread seconds.  It divides by the workers' own
time, not by the window.  None where the program keeps no wait span."""

WAITS = ("queue_wait", "epoch_wait", "result_wait")
STATES = WAITS + ("fe_stage", "fe_submit", "fe_wait", "fe_host_bt",
                  "graph_capture", "post_chain", "finalize",
                  "post_chain_py")


def read(m):
    c = m.counters
    if not sum(c.get(f"calls_{s}", 0) for s in WAITS):
        return None
    total = sum(c.get(f"time_{s}_s", 0.0) for s in STATES)
    if total <= 0:
        return None
    return 100.0 * sum(c.get(f"time_{s}_s", 0.0) for s in WAITS) / total

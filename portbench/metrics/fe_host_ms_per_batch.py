"""Host milliseconds per front-end batch, the wait on the card left
out: the engine's ``fe_stage`` (the reads' codes, the batch's host
arrays and its pinned upload), ``fe_submit`` (the graph's lookup and
replay, or the eager launch) and
``fe_host_bt`` (the host chain backtrack and its download) spans,
thread seconds summed over the workers, over its ``fe_batches`` count.
None where the program keeps no such spans."""

SPANS = ("fe_stage", "fe_submit", "fe_host_bt")


def read(m):
    c = m.counters
    n = c.get("fe_batches", 0)
    if not n or not c.get("calls_fe_submit", 0):
        return None
    return 1e3 * sum(c.get(f"time_{s}_s", 0.0) for s in SPANS) / n

"""Milliseconds per front-end batch that a worker waited on the card
for the batch's results: the engine's ``fe_wait`` span
(mappy_rs_tpu_torch/models/pipeline.py ``_fe_collect``: the wait on the
event recorded behind the chain table's copy; thread seconds summed over
the workers) over its ``fe_batches`` count.  None where the program
keeps no such span."""


def read(m):
    c = m.counters
    n = c.get("fe_batches", 0)
    if not n or not c.get("calls_fe_wait", 0):
        return None
    return 1e3 * c.get("time_fe_wait_s", 0.0) / n

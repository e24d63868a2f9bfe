"""Thread CPU time over thread time of the native post-chain call, in %:
the engine's ``cpu_post_chain_s`` over ``time_post_chain_s``
(mappy_rs_tpu_torch/models/pipeline.py ``_post_chain_native``).  Under
100 means a worker was off its core during the call (preempted, or
waiting for the interpreter lock on the way back).  None where the
program keeps no such span."""


def read(m):
    c = m.counters
    t = c.get("time_post_chain_s", 0.0)
    if t <= 0 or "cpu_post_chain_s" not in c:
        return None
    return 100.0 * c["cpu_post_chain_s"] / t

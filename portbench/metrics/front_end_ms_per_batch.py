"""Front-end milliseconds per device batch in the window: the engine's
``front_end`` timer (models/pipeline.py: staging and dispatch of a
batch, then the wait for its chain table and the download; thread
seconds summed over the workers, so the wait on the device is in it)
over its ``fe_batches`` count, retries included."""


def read(m):
    n = m.counters.get("fe_batches", 0)
    if not n:
        return None
    return 1e3 * m.counters.get("time_front_end_s", 0.0) / n

"""Share of the traced window in which no kernel, memcpy or memset ran
on the card (portbench/trace.py), in %."""


def read(m):
    p = m.profile
    if not p or not p["n_device_events"] or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])

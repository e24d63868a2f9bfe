"""Reads re-run by the front end at a 4x or 16x anchor budget
(``anchor_overflow_retries``) per 100 reads mapped in the window: the
work the front end throws away when a read's seed hits overflow A."""


def read(m):
    n = m.counters.get("reads", 0)
    if not n:
        return None
    return 100.0 * m.counters.get("anchor_overflow_retries", 0) / n

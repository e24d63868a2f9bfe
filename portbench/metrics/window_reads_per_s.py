"""Reads a closed loop completed per second: the reads the map_batch
iterators yielded inside the window, over the window (the whole
pipeline's rate, runtime down to the kernels).  Not an end-to-end
metric: on a shared host its runs spread by more than any bound allows
(PERF.md)."""


def read(m):
    lp = m.loop
    if lp.in_window is None:
        return None
    return len(lp.in_window) / lp.window_s

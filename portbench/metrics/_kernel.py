"""The roofline share of one kernel over a traced window: the least
time the card could take for the work the traced reads need (counted
from each read's plain anchor count, portbench/reference/anchors.py,
over every read that came back while the profiler recorded) over the
profiler's time of the kernel's launches (portbench/roofline.py)."""
from portbench import roofline


def share(m, kernel: str, prefix: str):
    p, w = m.profile, m.kernel_work
    if not p or not w:
        return None
    t = sum(s for n, s in p["kernel_s"].items() if kernel in n)
    if t <= 0 or w[prefix + "_bytes"] <= 0:
        return None
    need = roofline.bound_s(w[prefix + "_bytes"], w[prefix + "_ops"],
                            m.sm_count)
    return 100.0 * need / t

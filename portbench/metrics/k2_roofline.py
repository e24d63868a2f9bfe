"""K2 (csrc/backtrack.cu, the chain backtrack): its share of the
roofline."""
from portbench.metrics._kernel import share


def read(m):
    return share(m, "backtrack_kernel", "k2")

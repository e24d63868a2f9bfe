"""K1 (csrc/chain.cu, the chaining DP): its share of the roofline."""
from portbench.metrics._kernel import share


def read(m):
    return share(m, "chain_dp_kernel", "k1")

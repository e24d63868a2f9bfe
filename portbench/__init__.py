"""The benchmark of the PyTorch and CUDA port (mappy_rs_tpu_torch).

    python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of the root BENCHMARK.json once: makes the cell's genome
and reads from the seed, sets the port up (index build on the card,
the Aligner, its worker threads, a warm-up of the cell's own shapes),
measures for --seconds, checks the timed path's records against the
plain reference (portbench/reference/), and prints one JSON line.
Everything particular to a configuration, a traffic mix or a per-layer
metric sits in its own file (configs/, traffic/, metrics/), found by
the name BENCHMARK.json gives.  Nothing here imports JAX or the JAX
package; only the timed side imports the port.
"""

"""The control comes out not correct at the cell's own size, on the
card: the reference put in the program's place with its DP's scores in
bfloat16 (the guarantee "exact integer DP" broken) fails a number the
program passes.  Three seeds, each one `--control` run (a short window
at the cell's own load, then the program's and the control's records of
the run's sample judged alike).  The CPU counterpart at a tiny genome
is test_pb_reference.py."""
import json
import subprocess
import sys

import pytest

from portbench import run

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["ont-ecoli.wgs-8k"])
def test_control_fails_at_cell_size(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cell's own size runs there")
    for seed in SEEDS:
        out = subprocess.run(
            [sys.executable, "-m", "portbench", "--workload", cell, "--seed",
             str(seed), "--seconds", "10", "--control"], cwd=run.ROOT,
            capture_output=True, text=True, timeout=1200, check=True)
        got = json.loads(out.stdout.strip().splitlines()[-1])
        assert got["correct"] is False
        assert all(c["value"] <= c["limit"]
                   for c in got["program_checks"].values())

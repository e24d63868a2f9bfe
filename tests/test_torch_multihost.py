"""The port's decision step in two processes over torch.distributed.

Mirrors the JAX package's tests/test_multihost.py: two OS processes
(4 CPU cells each) join a Gloo process group, build the global
(data=4, index=2) grid with "index" inside each process, run the
decision step on their own rows and gather the results, which must
equal a one-process 8-cell run of the same step, array for array.
Each worker runs under a timeout; a worker that fails fails the test.
"""
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mh_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(nproc: int, n_local: int, out: str, port: int):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), str(nproc), str(n_local),
             out, str(port)],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for pid in range(nproc)
    ]
    logs = []
    try:
        for p in procs:
            o, _ = p.communicate(timeout=300)
            logs.append(o.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"
    return logs


def test_two_process_decision_step_matches_single(tmp_path):
    single = str(tmp_path / "single.npz")
    multi = str(tmp_path / "multi.npz")
    _run_workers(1, 8, single, _free_port())
    logs = _run_workers(2, 4, multi, _free_port())
    assert "rows [0, 1]" in logs[0] and "rows [2, 3]" in logs[1]
    a = np.load(single)
    b = np.load(multi)
    assert set(a.files) == set(b.files) and a.files
    for k in a.files:
        assert np.array_equal(a[k], b[k]), (
            f"{k} differs between one- and two-process runs:\n"
            f"single={a[k]}\nmulti ={b[k]}"
        )
    # the workload maps: exact contig slices chain and extend
    assert (a["chain_score"][:15] > 40).all()
    assert (a["ext_score"][:15] > 0).all()
    assert a["chain_score"][15] < 0  # the junk read

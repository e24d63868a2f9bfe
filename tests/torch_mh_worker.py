"""One process of a multi-process run of the port's decision step.

Launched by tests/test_torch_multihost.py as
``python tests/torch_mh_worker.py <pid> <nproc> <n_local_devices>
<out.npz> <port>``.  Every process builds the same inputs from a seed (a
4-contig genome and 16 reads: exact slices, reverse complements, one
junk read), joins the process group over Gloo, builds the global
(data, index) grid with n_local CPU cells of its own, runs the decision
step on its rows, gathers the full results, and process 0 writes them
to ``out.npz``.  With nproc=1 it is the one-process oracle.
"""
import os
import sys

pid, nproc, n_local, out_path, port = (
    int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
    sys.argv[4], int(sys.argv[5]),
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from mappy_rs_tpu_torch.config import MapOptions  # noqa: E402
from mappy_rs_tpu_torch.index.build import build_index  # noqa: E402
from mappy_rs_tpu_torch.ops.chain import ChainParams  # noqa: E402
from mappy_rs_tpu_torch.ops.extend import ExtendParams  # noqa: E402
from mappy_rs_tpu_torch.parallel.mesh import (  # noqa: E402
    P,
    build_sharded_map_step,
    device_shards,
    shard_index_by_key_range,
)
from mappy_rs_tpu_torch.parallel.multihost import (  # noqa: E402
    gather_results,
    init_distributed,
    make_global_mesh,
    put_global,
    put_global_tree,
    shard_specs_for_index,
)
from mappy_rs_tpu_torch.utils.seqcodes import encode  # noqa: E402
from mappy_rs_tpu_torch.utils.simulate import random_genome  # noqa: E402

init_distributed(f"localhost:{port}", nproc, pid, backend="gloo")

N_INDEX = 2
mesh = make_global_mesh(N_INDEX, devices=["cpu"] * n_local)
assert mesh.shape["data"] * N_INDEX == nproc * n_local

rng = np.random.default_rng(23)
ctgs = [random_genome(rng, n) for n in (50_000, 80_000, 30_000, 60_000)]
idx = build_index([(f"c{i}", c) for i, c in enumerate(ctgs)])
opt = MapOptions()
idx.update_map_options(opt)
B, L = 16, 512
codes = np.full((B, L), 4, np.uint8)
lens = np.zeros(B, np.int32)
for i in range(B):
    if i == B - 1:
        r = "ACGT" * 30
    else:
        c = ctgs[i % len(ctgs)]
        s = int(rng.integers(0, len(c) - 450))
        r = c[s:s + 450]
        if i % 3 == 0:
            r = r[::-1].translate(str.maketrans("ACGT", "TGCA"))
    e = encode(r)
    codes[i, : len(e)] = e
    lens[i] = len(e)

cp = ChainParams(
    max_dist_x=opt.max_gap, max_dist_y=opt.max_gap, bw=opt.bw,
    q_span=idx.k, chn_pen_gap=opt.chain_gap_scale * 0.01 * idx.k,
    chn_pen_skip=0.0,
)
ep = ExtendParams(
    a=opt.a, b=opt.b, q=opt.q, e=opt.e, q2=opt.q2, e2=opt.e2,
    sc_ambi=opt.sc_ambi,
)
step = build_sharded_map_step(
    mesh, idx.k, idx.w, max_minimizers=64, max_anchors=128,
    chain_params=cp, ext_params=ep, mid_occ=opt.mid_occ,
    chain_window=16, ext_window=64,
)
shards = put_global_tree(device_shards(shard_index_by_key_range(idx, N_INDEX)),
                         mesh, shard_specs_for_index())
res = gather_results(step(put_global(codes, mesh, P("data", None)),
                          put_global(lens, mesh, P("data")), shards))
if pid == 0:
    np.savez(out_path, **res)
if nproc > 1:
    torch.distributed.destroy_process_group()
print(f"[worker {pid}/{nproc}] ok, rows {list(mesh.local_rows)}", flush=True)

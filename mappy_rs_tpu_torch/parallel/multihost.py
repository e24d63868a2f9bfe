"""Multi-process execution over ``torch.distributed``: process group,
global grids, data placement, results.

Port of the JAX package's parallel/multihost.py.  The decision step
(parallel/mesh.py ``build_sharded_map_step``) needs no traffic between
processes by its layout: its only collectives (the anchor all_gather
and the extension pmax) ride the "index" axis, which stays inside a
process, while "data" spans processes.  So each process drives the
rows of the global grid that its own devices hold, and the one thing
that crosses processes is ``gather_results``: the host arrays of every
row, on every process.

  init_distributed()  — join the process group (one call per process)
  make_global_mesh()  — the (data, index) grid over every process's
                        devices, each process owning whole rows
  put_global()        — place host data on the rows this process owns
  gather_results()    — the full numpy results on every process

The backend is the caller's: "gloo" carries host arrays between
processes on the CPU, and serves two processes that share one card;
"nccl" needs a card per process.  tests/test_torch_multihost.py runs
two processes on the CPU and requires the gathered results to equal a
one-process grid's, array for array.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .mesh import DeviceMesh, P, Placed, _device


def _world() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def init_distributed(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    backend: str = "gloo",
) -> None:
    """Join the process group at `coordinator_address` ("host:port"; a
    TCP store that process 0 serves) as rank `process_id` of
    `num_processes`.  One process needs no group."""
    if num_processes <= 1:
        return
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )


def make_global_mesh(n_index: int = 1, devices=None) -> DeviceMesh:
    """(data, index) grid over every process's devices: this process's
    `devices` (default: its visible cards) form whole rows of n_index
    peers, so the "index" collectives stay inside the process; rank r
    owns rows [r * R, (r + 1) * R) of the world * R rows, and the cells
    of other processes' rows hold None.  Every process must bring as
    many devices."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    local = [_device(d) for d in devices]
    n_local = len(local)
    if n_local == 0 or (n_index > 1 and n_local % n_index != 0):
        raise ValueError(
            f"n_index={n_index} must divide the per-host device count "
            f"{n_local} so index-axis collectives stay on ICI"
        )
    rows = n_local // n_index
    world, rank = _world(), _rank()
    cells = np.empty((rows * world, n_index), object)
    for i, d in enumerate(local):
        cells[rank * rows + i // n_index, i % n_index] = d
    return DeviceMesh(cells, range(rank * rows, (rank + 1) * rows))


def put_global(arr: np.ndarray, mesh: DeviceMesh, spec: tuple) -> Placed:
    """Place host array `arr` (the global array, the same on every
    process) on this process's cells: each cell gets the block that
    `spec` gives it (a "data" dimension split over the grid's rows, an
    "index" dimension over a row's peers, None whole), as its own
    tensor on its device; cells on one device with one block share
    it."""
    arr = np.asarray(arr)
    spec = tuple(spec) + (None,) * (arr.ndim - len(spec))
    for dim, ax in enumerate(spec):
        if ax is not None and arr.shape[dim] % mesh.shape[ax]:
            raise ValueError(
                f"dimension {dim} ({arr.shape[dim]}) does not split over "
                f"the {mesh.shape[ax]} {ax!r} cells")
    blocks, memo = {}, {}
    for row in mesh.local_rows:
        for col in range(mesh.shape["index"]):
            ix = []
            for dim, ax in enumerate(spec):
                if ax is None:
                    ix.append((0, arr.shape[dim]))
                else:
                    size = arr.shape[dim] // mesh.shape[ax]
                    i = row if ax == "data" else col
                    ix.append((i * size, (i + 1) * size))
            dev = mesh.devices[row, col]
            key = (dev, tuple(ix))
            if key not in memo:
                block = arr[tuple(slice(a, b) for a, b in ix)]
                memo[key] = torch.from_numpy(np.ascontiguousarray(block)).to(dev)
            blocks[(row, col)] = memo[key]
    return Placed(arr.shape, spec, blocks)


def put_global_tree(arrays: Dict[str, np.ndarray], mesh: DeviceMesh,
                    specs: Dict[str, tuple]) -> Dict[str, Placed]:
    return {k: put_global(v, mesh, specs[k]) for k, v in arrays.items()}


def _local_rows(x: Placed) -> np.ndarray:
    """This process's rows of a Placed array split over "data" (the
    first peer's block of each row), or a replicated array's block."""
    if not x.spec or x.spec[0] != "data":
        return next(iter(x.blocks.values())).cpu().numpy()
    return np.concatenate([x.blocks[(r, 0)].cpu().numpy() for r in x.rows()])


def gather_results(tree: Dict[str, Placed]) -> Dict[str, np.ndarray]:
    """A dict of Placed results as complete numpy arrays on every
    process: each process's rows, exchanged through the process group
    (host arrays; ranks own consecutive rows, in rank order)."""
    local = {k: _local_rows(v) for k, v in tree.items()}
    world = _world()
    if world == 1:
        return local
    parts = [None] * world
    torch.distributed.all_gather_object(parts, local)
    return {k: (np.concatenate([p[k] for p in parts])
                if tree[k].spec and tree[k].spec[0] == "data" else local[k])
            for k in local}


def shard_specs_for_index() -> Dict[str, tuple]:
    """Partition specs of parallel/mesh.py ``device_shards``' arrays
    (as build_sharded_map_step reads them)."""
    return {
        "keys": P("index", None),
        "offcnt": P("index", None, None),
        "n_keys": P("index"),
        "pos_rp": P("index", None, None),
        "ref_blocks": P("index", None),
        "rid2shard": P(),
        "loc_off": P(),
    }

"""Index hand-off between processes through a directory of ``.npy`` files.

The process runtime (runtime/procpool.py, runtime/devowner.py) spawns
fresh interpreters; rebuilding or re-parsing the index in each child
would cost seconds to minutes at production scale.  The parent dumps the
raw host arrays once, and every child maps them back with
``np.load(mmap_mode="r")``: the pages are shared through the OS page
cache, so N children cost one physical copy and almost no load time.
A child that maps on the card uploads its own device tables from these
arrays (MinimizerIndex.device_index).

The JAX package has the same module (its index/share.py); this is the
port's own copy.
"""
from __future__ import annotations

import json
import os

import numpy as np

_ARRAYS = ("seq_lens", "keys", "key_offsets", "positions", "ref_codes")


def save_index_dir(index, d: str) -> None:
    """Dump a MinimizerIndex's raw arrays and metadata into directory d."""
    os.makedirs(d, exist_ok=True)
    for name in _ARRAYS:
        np.save(os.path.join(d, name + ".npy"), np.asarray(getattr(index, name)))
    meta = {
        "k": int(index.k),
        "w": int(index.w),
        "bucket_bits": int(index.bucket_bits),
        "flag": int(index.flag),
        "seq_names": list(index.seq_names),
    }
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_index_dir(d: str):
    """A MinimizerIndex from ``save_index_dir`` output.  The arrays come
    back as read-only memory maps; every consumer only reads them."""
    from .index import MinimizerIndex

    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    arrs = {
        name: np.load(os.path.join(d, name + ".npy"), mmap_mode="r")
        for name in _ARRAYS
    }
    return MinimizerIndex(
        k=meta["k"],
        w=meta["w"],
        bucket_bits=meta["bucket_bits"],
        flag=meta["flag"],
        seq_names=meta["seq_names"],
        **arrs,
    )

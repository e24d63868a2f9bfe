"""Fail before the set-up, naming each shortfall, when the host's RAM or
the card's free memory cannot hold the configuration's run.

Frozen from mappy_rs_tpu_torch/tools/gbp_chip.py ``host_ram`` /
``needs`` / ``preflight`` and tools/hbm_budget.py ``estimate`` (commit
112cabc5c64b).  Changed: the run maps through threads, so the children
and the index directory they read (RAM beyond the parent's, the
temporary directory's space) are not counted; the genome's host copy
made on the device is.
"""
from __future__ import annotations

from typing import Dict

#: hbm_budget's distinct keys per minimizer position (a uniformly random
#: genome's, above a repeat-rich genome's)
KEY_RATIO = 0.695


def host_ram() -> Dict[str, int]:
    """MemTotal and MemAvailable of /proc/meminfo, in bytes."""
    out = {}
    with open("/proc/meminfo") as fh:
        for line in fh:
            name, val = line.split(":", 1)
            if name in ("MemTotal", "MemAvailable"):
                out[name] = int(val.split()[0]) * 1024
    return out


def index_bytes(n_bp: int, w: int, k: int) -> Dict[str, int]:
    """hbm_budget.estimate: positions, keys and the DeviceIndex bytes."""
    m = int(2.0 * n_bp / (w + 1))
    n = int(KEY_RATIO * m)
    t = max(int(n / 0.75).bit_length(), 8)
    n_pad = max(((n + 127) // 128) * 128, 128)
    T = 1 << t
    total = (8 * n_pad + 8 * max(m, 8)
             + (8 if 2 * k > 31 else 4) * (T // 128 + 1) * 128
             + 4 * (T + 128))
    return {"positions": m, "keys": n, "total": total}


def needs(n_bp: int, w: int, k: int) -> Dict[str, float]:
    """Bytes the run needs: host RAM (the larger of the build's peak —
    genome, its concatenated copy, the per-contig and concatenated keys
    and y — and the mapped state: genome, its copy in the index, the
    index arrays and a host copy of the device tables), and card memory
    (the larger of the sort's keys, y, sorted keys and order, and the
    tables with their build scratch)."""
    est = index_bytes(n_bp, w, k)
    m, nk = est["positions"], est["keys"]
    index_host = n_bp + 16 * nk + 8 * m
    return {
        "host_ram": max(2 * n_bp + 32 * m, n_bp + index_host + est["total"]),
        "card": max(32 * m, est["total"] + 64 * nk),
    }


def preflight(n_bp: int, w: int, k: int, device) -> dict:
    """Raise, naming each shortfall, unless the host's available RAM and
    the card's free memory cover `needs`; else the needs and what is
    there."""
    import torch

    need = needs(n_bp, w, k)
    have = {"host_ram": host_ram()["MemAvailable"]}
    if torch.device(device).type == "cuda":
        have["card"] = torch.cuda.mem_get_info(torch.device(device))[0]
    short = [f"{n}: need {need[n] / 1e9:.2f} GB, have {have[n] / 1e9:.2f} GB"
             for n in have if have[n] < need[n]]
    if short:
        raise RuntimeError("not enough resources for this configuration: "
                           + "; ".join(short))
    return {"need": need, "have": have}

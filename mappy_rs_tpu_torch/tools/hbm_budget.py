"""Device memory of the port's minimizer index (index/index.py
``DeviceIndex``), exactly for a built index and estimated for a genome.

    python -m mappy_rs_tpu_torch.tools.hbm_budget [--card-gb=80]

Layout (``MinimizerIndex._build_device``):
    offcnt    int32 [n_pad, 2]          8 B per key, n_pad = max(ceil128(n), 128)
    pos_rp    int32 [max(m, 8), 2]      8 B per position
    hash_rows int32 or int64 [T/128 + 1, 128]
                                        4 B per slot, 8 B with two words (k > 15)
    hash_val  int32 [T + 128]           4 B per slot
with T = 2^t slots, t from max(bit_length(n / 0.75), 8) up until every
key sits within 128 slots of its hash.

The distinct-key ratio n / m depends on the genome: about 0.695 on a
32 Mbp uniformly random genome at w = 10, k = 15; 0.2364 on
tools/gbp_chip.py's 3.09 Gbp hg38-like genome, where repeats collapse
and k = 15 minimizers fill much of the 2^30 key space; about 0.18 for
minimap2's own hg38 map-ont index (~100M keys for ~560M positions).
The card's memory is read from the card (torch.cuda.mem_get_info) or
given as --card-gb off it.
"""
from __future__ import annotations

import sys


def count(n_keys: int, n_pos: int, t: int, two_word: bool) -> dict:
    """Bytes of each DeviceIndex tensor for n_keys keys, n_pos positions
    and a table of 2^t slots, and their sum ("total")."""
    n_pad = max(((n_keys + 127) // 128) * 128, 128)
    T = 1 << t
    out = {
        "offcnt": 8 * n_pad,
        "pos_rp": 8 * max(n_pos, 8),
        "hash_rows": (8 if two_word else 4) * (T // 128 + 1) * 128,
        "hash_val": 4 * (T + 128),
    }
    out["total"] = sum(out.values())
    return out


def start_bits(n_keys: int) -> int:
    """The table's starting t for n_keys keys (its least size)."""
    return max(int(n_keys / 0.75).bit_length(), 8)


def estimate(genome_bp: float, w: int = 10, k: int = 15,
             key_ratio: float = 0.695) -> dict:
    """The layout's bytes for a genome of genome_bp bases: 2 / (w + 1)
    minimizer positions per base, key_ratio distinct keys per position,
    T from the starting t (a build that moves t up doubles the two hash
    tables)."""
    m = int(2.0 * genome_bp / (w + 1))
    n = int(key_ratio * m)
    t = start_bits(n)
    return {"positions": m, "keys": n, "hash_bits": t,
            **count(n, m, t, two_word=2 * k > 31)}


def card_bytes(card_gb: float | None = None) -> float:
    """The card's memory in bytes: --card-gb if given, else the card's
    own total (torch.cuda.mem_get_info)."""
    if card_gb is not None:
        return card_gb * 1e9
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no card visible: give --card-gb")
    return float(torch.cuda.mem_get_info()[1])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    card_gb = next((float(a.split("=", 1)[1]) for a in argv
                    if a.startswith("--card-gb=")), None)
    # the index may take 90% of the card: the rest holds the front end's
    # batches, the build's sort scratch and the allocator's
    cap = card_bytes(card_gb) * 0.9
    for label, bp, ratios in (
        ("32 Mbp uniform", 32e6, (0.695,)),
        ("300 Mbp", 300e6, (0.695,)),
        ("3.1 Gbp", 3.1e9, (0.695, 0.2364, 0.18)),
    ):
        for r in ratios:
            b = estimate(bp, key_ratio=r)
            shards = 1
            while b["total"] / shards > cap:
                shards += 1
            print(f"{label:16s} key_ratio={r:.3f}: pos={b['positions'] / 1e6:.0f}M "
                  f"keys={b['keys'] / 1e6:.0f}M T=2^{b['hash_bits']} | "
                  f"offcnt {b['offcnt'] / 1e9:.2f} + pos_rp "
                  f"{b['pos_rp'] / 1e9:.2f} + hash "
                  f"{(b['hash_rows'] + b['hash_val']) / 1e9:.2f} = "
                  f"{b['total'] / 1e9:.2f} GB -> "
                  + ("fits one card" if shards == 1
                     else f"{shards} index shards"))
    return 0


if __name__ == "__main__":
    sys.exit(main())

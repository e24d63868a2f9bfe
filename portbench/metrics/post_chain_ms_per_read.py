"""Host post-chain milliseconds per read (the native post-chain's
regions, extension, CIGAR / cs and mapq, and the Python fallback's):
the engine's ``extend`` and ``finalize`` thread seconds over the reads
mapped in the window."""


def read(m):
    n = m.counters.get("reads", 0)
    if not n:
        return None
    return 1e3 * (m.counters.get("time_extend_s", 0.0)
                  + m.counters.get("time_finalize_s", 0.0)) / n

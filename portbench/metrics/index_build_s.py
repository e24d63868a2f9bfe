"""Seconds of the port's index build: the contig sketch and the sort
(index/build.py), the upload and the device tables (index/index.py),
as MinimizerIndex.build_seconds records them."""


def read(m):
    return sum(m.build_seconds.values()) if m.build_seconds else None

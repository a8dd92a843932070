"""recs_per_s.topn: users whose top-n lists reached the host in the
measured window, over the window's seconds (host clock): the serving
pass's throughput, the rated bits' upload from pageable memory included.
That upload's pace follows the host's memory and spreads by some 10-15%
from process to process, so the throughput is read here, beside the
cell's end-to-end kernel time a pass."""


def read(ctx):
    v = getattr(ctx, "recs_per_s", None)
    return v if v else None

"""Host ingest bench: the port's counterpart of ``tools/bench_ingest.py``.

Times the port's ``data.movielens.load_movielens`` (the native parser,
built with g++ at first use, then the id densify) on an ML-20M-format ``ratings.csv``, and the port's
layout builds (``ops.bucketed.build_bucketed`` for both sides at rank 64
and 8 groups, ``ops.layout.build_blocked_csr`` for users) on what it
parsed. The file is written first if it does not exist, in the format and
from the seed of ``tools/bench_ingest.py``, so both benches can read one
file. Host only: needs no GPU. Prints one JSON line per stage.

    python -m ycnr_tpu_torch.tools.bench_ingest --path ratings.csv \
        [--rows 20000000]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ycnr_tpu_torch.data.movielens import load_movielens
from ycnr_tpu_torch.ops.bucketed import build_bucketed
from ycnr_tpu_torch.ops.layout import build_blocked_csr

LEVELS = np.arange(1, 11) * 0.5  # ML-20M rating grid 0.5..5.0


def generate(path: str, rows: int, n_users=138_493, n_items=131_262,
             seed=0, chunk=1_000_000):
    """userId,movieId,rating,timestamp rows, uniform ids and levels."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        f.write("userId,movieId,rating,timestamp\n")
        for lo in range(0, rows, chunk):
            n = min(chunk, rows - lo)
            u = rng.integers(1, n_users + 1, n)
            i = rng.integers(1, n_items + 1, n)
            r = LEVELS[rng.integers(0, len(LEVELS), n)]
            ts = rng.integers(789_652_009, 1_427_784_002, n)
            f.write("\n".join(
                f"{a},{b},{c:g},{d}" for a, b, c, d in zip(u, i, r, ts)))
            f.write("\n")


def stage(name: str, t0: float, **kw):
    print(json.dumps({"stage": name, "s": round(time.time() - t0, 2), **kw}),
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", required=True, help="ratings.csv to read "
                    "(written first if missing)")
    ap.add_argument("--rows", type=int, default=20_000_000)
    args = ap.parse_args(argv)
    if not os.path.exists(args.path):
        t0 = time.time()
        generate(args.path, args.rows)
        stage("generate", t0, rows=args.rows)
    with open(args.path, "rb") as f:  # parse from the page cache
        while f.read(1 << 24):
            pass
    t0 = time.time()
    u, i, r, n_users, n_items = load_movielens(args.path)
    stage("load_movielens", t0, rows=int(len(u)), n_users=n_users,
          n_items=n_items, mb=round(os.path.getsize(args.path) / 1e6, 1))
    t0 = time.time()
    build_bucketed(u, i, r, n_users, n_items, 32, 64, max_groups=8)
    build_bucketed(i, u, r, n_items, n_users, 32, 64, max_groups=8)
    stage("build_bucketed, both sides", t0)
    t0 = time.time()
    build_blocked_csr(u, i, r, n_users, n_items, 32, rank_hint=64)
    stage("build_blocked_csr, users", t0)


if __name__ == "__main__":
    main()

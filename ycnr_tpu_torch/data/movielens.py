"""MovieLens file parsers (the port's copy of ``ycnr_tpu/data/movielens.py``).

Parses ``u.data`` (tab), ``ratings.dat`` (``::``) and ``ratings.csv``
(comma) straight to packed int32/float32 arrays. As in the JAX package,
the native C++ parser (``data/native.py``, ``csrc/ingest.cc``) goes first;
the Python parser serves a host without ``g++`` and files on which the
native parser finds no row it can read, and skips malformed rows as the
native one does, so a file gives the same arrays either way. Raw ids are
densified to contiguous row indices.
"""

from __future__ import annotations

import os

import numpy as np

from ycnr_tpu_torch.data.native import parse_ratings_native

_FORMATS = {
    ".data": "\t",  # ml-100k u.data: user \t item \t rating \t ts
    ".dat": "::",  # ml-1m/10m ratings.dat: user::item::rating::ts
    ".csv": ",",  # ml-20m+ ratings.csv: userId,movieId,rating,timestamp
}


def _sep_for(path: str) -> str:
    ext = os.path.splitext(path)[1]
    if ext not in _FORMATS:
        raise ValueError(f"unrecognized MovieLens file extension: {path}")
    return _FORMATS[ext]


def _parse_python(path: str, sep: str, want_ts: bool = False):
    users, items, ratings, ts = [], [], [], []
    with open(path, "r", encoding="utf-8") as f:
        first = True
        for line in f:
            line = line.strip()
            if not line:
                continue
            if first:
                first = False
                if line.lower().startswith("userid"):  # csv header
                    continue
            parts = line.split(sep)
            # skip malformed rows instead of aborting the parse, as the
            # native parser does, so a file imports the same either way
            try:
                uu = int(parts[0])
                ii = int(parts[1])
                rr = float(parts[2])
            except (ValueError, IndexError):
                continue
            users.append(uu)
            items.append(ii)
            ratings.append(rr)
            if want_ts:
                # some exports drop or mangle the timestamp column; ts=0
                # keeps the row either way (matches the native parser)
                try:
                    ts.append(int(float(parts[3])) if len(parts) > 3 else 0)
                except ValueError:
                    ts.append(0)
    out = (np.asarray(users, np.int64), np.asarray(items, np.int64),
           np.asarray(ratings, np.float32))
    return out + (np.asarray(ts, np.int64),) if want_ts else out


def _densify(x: np.ndarray):
    """(sorted unique ids, dense inverse) — np.unique semantics.

    MovieLens-style ids live in a bounded range, so a presence bitmap +
    prefix-sum remap is O(n + max_id) instead of np.unique's O(n log n)
    sort — at 20M rows this is the difference between ~25 s and ~1 s on the
    import host (tools/bench_ingest.py). Falls back to np.unique when the
    id space is sparse enough that the bitmap would dominate."""
    if len(x) == 0:
        return np.empty(0, np.int64), x.astype(np.int64)
    lo, hi = int(x.min()), int(x.max())
    if lo < 0 or hi > 8 * len(x) + (1 << 16):
        uu, inv = np.unique(x, return_inverse=True)
        return uu, inv
    present = np.zeros(hi + 1, bool)
    present[x] = True
    ids = np.flatnonzero(present)
    remap = np.zeros(hi + 1, np.int32)  # dense ids fit int32 by definition
    remap[ids] = np.arange(len(ids), dtype=np.int32)
    return ids.astype(np.int64), remap[x]


def load_movielens(path: str, densify: bool = True, return_maps: bool = False,
                   return_ts: bool = False):
    """Parse a MovieLens ratings file.

    Returns (user_idx, item_idx, rating, n_users, n_items). With
    ``densify=True`` raw ids are remapped to contiguous [0, n) indices;
    pass ``return_maps=True`` to also get (user_ids, item_ids) arrays
    mapping dense index -> original dataset id (needed to serve results in
    the dataset's id space — the reference reads ids straight from its DB).
    ``return_ts=True`` appends the int64 timestamp column (reference call
    stack 3.1 parses it; 0 where the file has no 4th field) — the input
    for time-ordered splits (data/split.py time_split).
    """
    sep = _sep_for(path)
    ts = None
    parsed = parse_ratings_native(path, sep, want_ts=return_ts)
    if parsed is None:
        parsed = _parse_python(path, sep, want_ts=return_ts)
    if return_ts:
        u, i, r, ts = parsed
    else:
        u, i, r = parsed

    if densify:
        uu, u = _densify(u)
        ii, i = _densify(i)
        n_users, n_items = len(uu), len(ii)
    else:
        uu = np.arange(int(u.max()) + 1 if len(u) else 0, dtype=np.int64)
        ii = np.arange(int(i.max()) + 1 if len(i) else 0, dtype=np.int64)
        n_users, n_items = len(uu), len(ii)
    out = (u.astype(np.int32, copy=False), i.astype(np.int32, copy=False),
           r.astype(np.float32, copy=False), n_users, n_items)
    if return_maps:
        out = out + (uu.astype(np.int64), ii.astype(np.int64))
    if return_ts:
        out = out + (ts.astype(np.int64, copy=False),)
    return out

"""Ratings store with portioned streaming: the port's own copy of
``ycnr_tpu/data/store.py`` (NumPy only; the port imports nothing of the
JAX package).

The durable store is a binary columnar directory (u.npy/i.npy/r.npy +
meta.json): append batches, stream fixed-size portions, and hand the full
COO to the layout builder. The on-disk format is the JAX package's, so a
store written by either package reads back in the other
(``tests/test_torch_host_copies.py`` holds that both ways).
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Tuple

import numpy as np

_META = "meta.json"


class RatingsStore:
    """Append-only columnar ratings store on disk."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._meta_path = os.path.join(path, _META)
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                self.meta = json.load(f)
        else:
            self.meta = {"n_rows": 0, "n_users": 0, "n_items": 0,
                         "segments": []}

    def _save_meta(self):
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.meta, f)
        os.replace(tmp, self._meta_path)

    def append(self, user_idx, item_idx, rating, ts=None):
        """Append one batch (the reference's batched INSERT, call stack 3.1).

        ``ts`` (optional int64 timestamps — the reference keeps them in its
        DB rows) must be given either for every append or for none: a store
        with a partial timestamp column could not honor a time split."""
        u = np.asarray(user_idx, np.int32)
        i = np.asarray(item_idx, np.int32)
        r = np.asarray(rating, np.float32)
        if not (len(u) == len(i) == len(r)):
            raise ValueError("batch arrays must share length")
        if self.meta["segments"]:
            if bool(self.meta.get("has_ts")) != (ts is not None):
                raise ValueError(
                    "timestamp column must be given for every append or "
                    "for none (store has_ts="
                    f"{bool(self.meta.get('has_ts'))})")
        seg = len(self.meta["segments"])
        base = os.path.join(self.path, f"seg{seg:05d}")
        np.save(base + ".u.npy", u)
        np.save(base + ".i.npy", i)
        np.save(base + ".r.npy", r)
        if ts is not None:
            t = np.asarray(ts, np.int64)
            if len(t) != len(u):
                raise ValueError("batch arrays must share length")
            np.save(base + ".t.npy", t)
            self.meta["has_ts"] = True
        self.meta["segments"].append({"name": f"seg{seg:05d}", "rows": len(u)})
        self.meta["n_rows"] += len(u)
        if len(u):
            self.meta["n_users"] = max(self.meta["n_users"], int(u.max()) + 1)
            self.meta["n_items"] = max(self.meta["n_items"], int(i.max()) + 1)
        self._save_meta()

    def stream(self, portion: int = 1_000_000
               ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yield (u, i, r) portions of at most `portion` rows (the
        reference's portioned SELECT streaming)."""
        buf_u, buf_i, buf_r, have = [], [], [], 0
        for seg in self.meta["segments"]:
            base = os.path.join(self.path, seg["name"])
            u = np.load(base + ".u.npy", mmap_mode="r")
            i = np.load(base + ".i.npy", mmap_mode="r")
            r = np.load(base + ".r.npy", mmap_mode="r")
            pos = 0
            while pos < len(u):
                take = min(portion - have, len(u) - pos)
                buf_u.append(np.asarray(u[pos:pos + take]))
                buf_i.append(np.asarray(i[pos:pos + take]))
                buf_r.append(np.asarray(r[pos:pos + take]))
                have += take
                pos += take
                if have == portion:
                    yield (np.concatenate(buf_u), np.concatenate(buf_i),
                           np.concatenate(buf_r))
                    buf_u, buf_i, buf_r, have = [], [], [], 0
        if have:
            yield (np.concatenate(buf_u), np.concatenate(buf_i),
                   np.concatenate(buf_r))

    def set_id_maps(self, user_ids, item_ids):
        """Persist dense-index -> original-dataset-id maps (the reference
        keeps original ids in its DB; we densify at import and must be able
        to serve results back in the dataset's id space)."""
        np.save(os.path.join(self.path, "user_ids.npy"),
                np.asarray(user_ids, np.int64))
        np.save(os.path.join(self.path, "item_ids.npy"),
                np.asarray(item_ids, np.int64))
        self.meta["has_id_maps"] = True
        self._save_meta()

    def id_maps(self):
        """(user_ids, item_ids) arrays, or None if import didn't store them."""
        if not self.meta.get("has_id_maps"):
            return None
        return (np.load(os.path.join(self.path, "user_ids.npy")),
                np.load(os.path.join(self.path, "item_ids.npy")))

    def read_all(self):
        parts = list(self.stream())
        if not parts:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                    np.zeros(0, np.float32))
        return tuple(np.concatenate(x) for x in zip(*parts))

    def read_ts(self):
        """The full timestamp column (int64), or None if the import didn't
        store one. Segment order matches read_all()."""
        if not self.meta.get("has_ts"):
            return None
        return np.concatenate([
            np.load(os.path.join(self.path, seg["name"] + ".t.npy"))
            for seg in self.meta["segments"]]) if self.meta["segments"] \
            else np.zeros(0, np.int64)

    @property
    def n_rows(self) -> int:
        return self.meta["n_rows"]

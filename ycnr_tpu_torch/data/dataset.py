"""Dataset assembly: source -> split -> blocked layouts (the port's copy of
``ycnr_tpu/data/dataset.py``).

This is the rebuild of the reference's `prepare` stage (SURVEY.md call stack
3.1 + the ingestion half of 3.2): rows -> train/test split -> packed per-user
and per-item (transposed) views. The BlockedCSR views are built LAZILY: the
training fast path uses the bucketed layout instead (models/bucketed_phase),
so the blocked views only materialize for consumers that need them
(recommend_all's rated-item masks, the blocked solver, sharded stacking).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ycnr_tpu_torch.config import DataConfig
from ycnr_tpu_torch.data.movielens import load_movielens
from ycnr_tpu_torch.data.split import split_coo
from ycnr_tpu_torch.data.synthetic import (synthetic_ratings,
                                           synthetic_ratings_calibrated)
from ycnr_tpu_torch.ops.layout import BlockedCSR, build_blocked_csr, pad_coo


@dataclass
class Dataset:
    n_users: int
    n_items: int
    # train COO (host, for SGD shuffling, serving masks, bucketed builds)
    train_u: np.ndarray
    train_i: np.ndarray
    train_r: np.ndarray
    # held-out COO
    test_u: np.ndarray
    test_i: np.ndarray
    test_r: np.ndarray
    mu: float  # global mean of train ratings (SGD baseline term)
    # layout build parameters (used on first access)
    chunk_len: int = 32
    block_chunks: Optional[int] = None
    rank_hint: int = 64
    # lazily built blocked views (set explicitly to override)
    user_layout_cache: Optional[BlockedCSR] = field(default=None, repr=False)
    item_layout_cache: Optional[BlockedCSR] = field(default=None, repr=False)

    @property
    def nnz(self) -> int:
        return len(self.train_r)

    @property
    def user_layout(self) -> BlockedCSR:
        """entity=user, other=item (U-step / serving masks); built on demand."""
        if self.user_layout_cache is None:
            self.user_layout_cache = build_blocked_csr(
                self.train_u, self.train_i, self.train_r, self.n_users,
                self.n_items, self.chunk_len, self.block_chunks,
                self.rank_hint)
        return self.user_layout_cache

    @property
    def item_layout(self) -> BlockedCSR:
        """entity=item, other=user (V-step transposed view); built on demand."""
        if self.item_layout_cache is None:
            self.item_layout_cache = build_blocked_csr(
                self.train_i, self.train_u, self.train_r, self.n_items,
                self.n_users, self.chunk_len, self.block_chunks,
                self.rank_hint)
        return self.item_layout_cache

    def padded_test(self, multiple: int = 1024):
        return pad_coo(self.test_u, self.test_i, self.test_r,
                       self.n_users, self.n_items, multiple)


def _load_source(cfg: DataConfig, want_ts: bool = False):
    if cfg.source == "synthetic":
        if cfg.synthetic_mode == "calibrated":
            u, i, r = synthetic_ratings_calibrated(
                cfg.n_users, cfg.n_items, cfg.n_ratings, cfg.true_rank,
                cfg.noise, cfg.seed)
        elif cfg.synthetic_mode == "planted":
            u, i, r = synthetic_ratings(cfg.n_users, cfg.n_items,
                                        cfg.n_ratings, cfg.true_rank,
                                        cfg.noise, cfg.seed)
        else:
            raise ValueError(
                f"synthetic_mode must be 'planted' or 'calibrated', got "
                f"{cfg.synthetic_mode!r}")
        # synthetic "time" = stream order (deterministic, monotone)
        ts = np.arange(len(r), dtype=np.int64) if want_ts else None
        return u, i, r, cfg.n_users, cfg.n_items, ts
    if cfg.path is None:
        raise ValueError(
            f"source {cfg.source!r} needs data.path (no network in this "
            "environment; see SURVEY.md §7)")
    out = load_movielens(cfg.path, return_ts=want_ts)
    if want_ts:
        u, i, r, n_users, n_items, ts = out
        return u, i, r, n_users, n_items, ts
    return out + (None,)


def load_dataset(cfg: DataConfig, rank_hint: int = 64,
                 block_chunks: Optional[int] = None) -> Dataset:
    want_ts = cfg.split != "random"
    u, i, r, n_users, n_items, ts = _load_source(cfg, want_ts=want_ts)
    # iALS consumes raw r as confidence (c = 1 + alpha*r) and binarizes
    # preferences internally (p = 1 on observed pairs) - no flag needed.
    (tu, ti, tr), (su, si, sr) = split_coo(
        u, i, r, ts, method=cfg.split, test_fraction=cfg.test_fraction,
        seed=cfg.seed, last_k=cfg.last_k)
    return Dataset(
        n_users=n_users, n_items=n_items,
        train_u=tu, train_i=ti, train_r=tr,
        test_u=su, test_i=si, test_r=sr,
        mu=float(tr.mean()) if len(tr) else 0.0,
        chunk_len=cfg.chunk_len,
        block_chunks=block_chunks if block_chunks is not None
        else cfg.block_chunks,
        rank_hint=rank_hint,
    )

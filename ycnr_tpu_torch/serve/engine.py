"""Serving facade: ``recommend(user, n)`` with a cache in front
(counterpart of ``ycnr_tpu/serve/engine.py``).

Online updates (``add_ratings``, ``compact``), cold-user fold-in,
``popular`` and ``similar`` are not ported yet, so the rated index is fixed
at construction.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ycnr_tpu_torch import full_precision_matmul
from ycnr_tpu_torch.eval.recommend import (
    NEG_INF,
    overfetch_n,
    recommend_all,
    recommend_users,
)
from ycnr_tpu_torch.models.base import MFState, predict
from ycnr_tpu_torch.serve.cache import RecCache
from ycnr_tpu_torch.shared import build_blocked_csr


class Recommender:
    def __init__(self, state: MFState, train_u, train_i, train_r=None,
                 cache: Optional[RecCache] = None):
        full_precision_matmul()
        self.state = state
        train_u = np.asarray(train_u)
        train_i = np.asarray(train_i)
        # one-time sort so per-request mask building is O(log nnz)
        order = np.argsort(train_u, kind="stable")
        self._index = (train_u[order], train_i[order],
                       None if train_r is None
                       else np.asarray(train_r, np.float32)[order])
        # fixed mask width = the hottest user's rated count
        counts = np.bincount(train_u, minlength=1) if len(train_u) else [1]
        self._mask_width = int(max(8, np.max(counts)))
        self.cache = cache if cache is not None else RecCache()
        # bumped on every state swap; lets readers detect that a result
        # they computed became stale before caching it
        self._version = 0

    def _user_items(self, user_id: int) -> np.ndarray:
        """The user's rated items (probe with su's dtype: a Python int
        would upcast the whole index on every call)."""
        su, si, _ = self._index
        uid = su.dtype.type(user_id)
        return si[np.searchsorted(su, uid):np.searchsorted(su, uid, "right")]

    def _user_items_batch(self, user_ids) -> list:
        """Per-user rated sets for a batch: two vectorized probes."""
        su, si, _ = self._index
        uids = np.asarray(user_ids, su.dtype)
        s = np.searchsorted(su, uids)
        t = np.searchsorted(su, uids, side="right")
        return [si[s[k]:t[k]] for k in range(len(uids))]

    def _check_users(self, user_ids: np.ndarray):
        # out-of-range ids would gather the zero trash row and return (then
        # cache) bias-only recommendations
        if len(user_ids) and (int(user_ids.min()) < 0
                              or int(user_ids.max()) >= self.state.n_users):
            bad = user_ids[(user_ids < 0)
                           | (user_ids >= self.state.n_users)]
            raise IndexError(
                f"user ids {bad.tolist()[:5]} not in trained factors "
                f"(0..{self.state.n_users - 1})")

    def _check_items(self, item_ids: np.ndarray):
        if len(item_ids) and (int(item_ids.min()) < 0
                              or int(item_ids.max()) >= self.state.n_items):
            bad = item_ids[(item_ids < 0)
                           | (item_ids >= self.state.n_items)]
            raise IndexError(f"item ids {bad.tolist()[:5]} not in the "
                             f"catalog (0..{self.state.n_items - 1})")

    def recommend(self, user_id: int, n: int = 10, exclude=None):
        """Top-n item ids for one user (rated items masked). ``exclude``
        drops extra catalog ids by over-fetching and filtering, so the
        result stays exact."""
        if exclude is not None and len(exclude):
            ex = np.asarray(exclude).reshape(-1)
            self._check_items(ex)
            wide = self.recommend(user_id, overfetch_n(n, len(ex)))
            return wide[~np.isin(wide, ex)][:n]
        self._check_users(np.asarray([user_id]))
        key = (int(user_id), int(n))
        hit = self.cache.get(key)
        if hit is not None:
            return hit
        v0 = self._version
        items, scores = recommend_users(
            self.state, None, None, np.asarray([user_id]), n,
            rated_lists=[self._user_items(user_id)],
            min_width=self._mask_width)
        # when n exceeds the user's unrated count, top-k fills the tail
        # with NEG_INF-masked entries — drop them
        result = items[0][scores[0] > NEG_INF / 2]
        self.cache.put_if(key, result, lambda: self._version == v0)
        return result

    def recommend_batch(self, user_ids: Sequence[int], n: int = 10):
        """Top-n per user as a list of arrays (ragged: NEG_INF tails of
        users with fewer than n unrated items are dropped)."""
        user_ids = np.asarray(user_ids)
        self._check_users(user_ids)
        items, scores = recommend_users(
            self.state, None, None, user_ids, n,
            rated_lists=self._user_items_batch(user_ids),
            min_width=self._mask_width)
        return [items[j][scores[j] > NEG_INF / 2]
                for j in range(len(user_ids))]

    def precompute_all(self, n: int = 10, method: str = "fused") -> int:
        """Fill the cache for every rated user in one device pass (K2 for
        the fused methods). Returns the number of users cached."""
        su, si, sr = self._index
        r = np.ones(len(su), np.float32) if sr is None else sr
        lay = build_blocked_csr(su, si, r, self.state.n_users,
                                self.state.n_items,
                                rank_hint=self.state.rank)
        v0 = self._version
        users, items, scores = recommend_all(self.state, lay, n=n,
                                             method=method)
        count = 0
        for uid, row, sc in zip(users, items, scores):
            if self.cache.put_if((int(uid), int(n)), row[sc > NEG_INF / 2],
                                 lambda: self._version == v0):
                count += 1
        return count

    def predict(self, user_id: int, item_ids) -> np.ndarray:
        """Predicted ratings for one trained user against catalog items."""
        user_id = int(user_id)
        self._check_users(np.asarray([user_id]))
        item_ids = np.asarray(item_ids).reshape(-1)
        if len(item_ids) == 0:
            return np.empty(0, np.float32)
        self._check_items(item_ids)
        dev = self.state.U.device
        u = torch.full((len(item_ids),), user_id, dtype=torch.long,
                       device=dev)
        i = torch.as_tensor(item_ids, dtype=torch.long, device=dev)
        return predict(self.state, u, i).cpu().numpy()

    def update_state(self, state: MFState):
        """Swap in retrained factors and flush the cache. The version is
        bumped before the flush, so a reader's put_if that raced past the
        bump is cleared by it."""
        self.state = state
        self._version += 1
        self.cache.invalidate()

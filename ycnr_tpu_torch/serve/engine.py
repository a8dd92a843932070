"""Serving facade: ``recommend(user, n)`` with a cache in front
(counterpart of ``ycnr_tpu/serve/engine.py``).

Online updates (``add_ratings``) are amortized: each call appends to a small
per-user pending log (O(user's own count) host work) and the global COO
arrays + sorted serving index are rebuilt only when the pending volume
crosses a threshold — a stream of updates costs amortized O(1) copies of
the full rating set instead of one O(nnz) splice per call. The re-solve of
the user's row is the port's fold-in: row gather + K1 on the card.
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
    top_popular,
)
from ycnr_tpu_torch.eval.similar import similar_items
from ycnr_tpu_torch.models.base import MFState, predict
from ycnr_tpu_torch.serve.cache import RecCache
from ycnr_tpu_torch.serve.fold_in import fold_in_users, recommend_fold_in
from ycnr_tpu_torch.ops.layout import build_blocked_csr


class Recommender:
    def __init__(self, state: MFState, train_u, train_i, train_r=None,
                 cache: Optional[RecCache] = None,
                 compact_threshold: Optional[int] = None):
        full_precision_matmul()
        self.state = state
        self.train_u = np.asarray(train_u)
        self.train_i = np.asarray(train_i)
        # ratings are only needed for online updates (add_ratings)
        self.train_r = None if train_r is None else np.asarray(train_r,
                                                               np.float32)
        # one-time sort so per-request mask building is O(log nnz). The
        # sorted index AND the pending-update log live in ONE tuple
        # attribute ((su, si, sr), pending_dict) swapped wholesale, so a
        # concurrent reader always snapshots a CONSISTENT pair across a
        # compact() (which folds pending into the base) or update_state.
        self._index = (self._sorted_index(), {})
        # fixed mask width = the hottest user's rated count
        counts = np.bincount(self.train_u,
                             minlength=1) if len(self.train_u) else [1]
        self._mask_width = int(max(8, np.max(counts)))
        self.cache = cache if cache is not None else RecCache()
        self._pending_n = 0
        self._compact_threshold = compact_threshold
        # bumped on every state swap/update; lets readers detect that a
        # result they computed became stale before caching it
        self._version = 0

    # -- rated-list plumbing (base index + pending overlay) ----------------

    # Probe `su` (int32) with su.dtype scalars/arrays only: a Python int
    # would upcast the whole index on every call.

    def _sorted_index(self):
        order = np.argsort(self.train_u, kind="stable")
        return (self.train_u[order], self.train_i[order],
                None if self.train_r is None else self.train_r[order])

    def _user_items(self, user_id: int) -> np.ndarray:
        """The user's full current rated-item set (base + pending)."""
        (su, si, _), pending = self._index  # one atomic snapshot
        uid = su.dtype.type(user_id)
        base = si[np.searchsorted(su, uid):np.searchsorted(su, uid, "right")]
        pend = pending.get(int(user_id))
        if pend is None:
            return base
        return np.union1d(base, pend[0])

    def _user_items_batch(self, user_ids) -> list:
        """Per-user rated sets for a batch: two vectorized probes."""
        (su, si, _), pending = self._index  # one atomic snapshot
        uids = np.asarray(user_ids, su.dtype)
        s = np.searchsorted(su, uids)
        t = np.searchsorted(su, uids, side="right")
        out = []
        for k in range(len(uids)):
            base = si[s[k]:t[k]]
            pend = pending.get(int(uids[k]))
            out.append(base if pend is None else np.union1d(base, pend[0]))
        return out

    def _user_items_ratings(self, user_id: int):
        """(items, ratings) with pending overlaying base (replacement
        semantics: a re-rated item takes the pending value)."""
        (su, si, sr), pending = self._index
        uid = su.dtype.type(user_id)
        s = np.searchsorted(su, uid)
        t = np.searchsorted(su, uid, side="right")
        base_i = si[s:t]
        base_r = sr[s:t] if sr is not None else np.zeros(t - s, np.float32)
        pend = pending.get(int(user_id))
        if pend is None:
            return base_i, base_r
        pi, pr = pend
        keep = ~np.isin(base_i, pi)
        return (np.concatenate([base_i[keep], pi]),
                np.concatenate([base_r[keep], pr]))

    def pending_count(self) -> int:
        return self._pending_n

    def compact(self):
        """Fold the pending log into the base arrays (one O(nnz) pass over
        packed (user, item) keys — NOT per pending user). Called
        automatically when pending volume crosses the threshold."""
        _, pending = self._index
        if not pending:
            return
        ni = np.int64(self.state.n_items) + 1
        pend_keys = np.concatenate(
            [np.int64(u) * ni + pi.astype(np.int64)
             for u, (pi, _) in pending.items()])
        keys = self.train_u.astype(np.int64) * ni \
            + self.train_i.astype(np.int64)
        keep = ~np.isin(keys, pend_keys)
        add_u = [np.full(len(pi), u, self.train_u.dtype)
                 for u, (pi, _) in pending.items()]
        add_i = [pi.astype(self.train_i.dtype)
                 for _, (pi, _) in pending.items()]
        self.train_u = np.concatenate([self.train_u[keep]] + add_u)
        self.train_i = np.concatenate([self.train_i[keep]] + add_i)
        if self.train_r is not None:
            add_r = [pr for _, (_, pr) in pending.items()]
            self.train_r = np.concatenate([self.train_r[keep]] + add_r)
        self._index = (self._sorted_index(), {})
        self._pending_n = 0
        # base item counts just changed; cached popularity lists are stale
        self.cache.invalidate_popular()

    def _maybe_compact(self):
        thresh = self._compact_threshold
        if thresh is None:
            thresh = max(4096, len(self.train_u) // 100)
        if self._pending_n >= thresh:
            self.compact()

    # -- serving -----------------------------------------------------------

    def _check_users(self, user_ids: np.ndarray):
        # out-of-range ids would gather the zero trash row and return (then
        # cache) bias-only recommendations
        if len(user_ids) and (int(user_ids.min()) < 0
                              or int(user_ids.max()) >= self.state.n_users):
            bad = user_ids[(user_ids < 0)
                           | (user_ids >= self.state.n_users)]
            raise IndexError(
                f"user ids {bad.tolist()[:5]} not in trained factors "
                f"(0..{self.state.n_users - 1}); use recommend_cold for "
                f"new users")

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
        the fused methods). Pending online updates are compacted into the
        base index first so the cached lists respect them. Returns the
        number of users cached."""
        self.compact()
        (su, si, sr), _ = self._index
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

    def popular(self, n: int = 10):
        """Top-n items by training rating count — the zero-history
        fallback (a brand-new user has nothing to fold in). Computed from
        the CURRENT index (base + compacted online updates) and cached
        per call count; update_state flushes with everything else."""
        key = ("pop", 0, int(n), "count")
        hit = self.cache.get(key)
        if hit is not None:
            return hit
        v0 = self._version
        (_, si, _), _ = self._index
        result = top_popular(si, self.state.n_items, n)
        self.cache.put_if(key, result, lambda: self._version == v0)
        return result

    def similar(self, item_id: int, n: int = 10, metric: str = "cosine"):
        """Top-n most similar catalog items to item_id by factor-row
        similarity (eval/similar.py). Cached under a ("sim", ...) key
        namespace; online updates (add_ratings) leave V untouched so
        similarity entries survive per-user invalidation, while a factor
        republish (update_state) flushes them with everything else."""
        item_id = int(item_id)
        self._check_items(np.asarray([item_id]))
        if metric not in ("cosine", "dot"):
            # validate BEFORE the cache probe, so an unknown metric raises
            # whatever the cache holds
            raise ValueError(
                f"metric must be 'cosine' or 'dot', got {metric!r}")
        key = ("sim", item_id, int(n), metric)
        hit = self.cache.get(key)
        if hit is not None:
            return hit
        v0 = self._version
        items, scores = similar_items(self.state, [item_id], n, metric)
        result = items[0][scores[0] > NEG_INF / 2]
        self.cache.put_if(key, result, lambda: self._version == v0)
        return result

    def precompute_similar(self, n: int = 10, metric: str = "cosine",
                           chunk: int = 1024) -> int:
        """Bulk-fill the similarity cache for EVERY catalog item — the
        item-side analog of precompute_all. Chunked so the [B, n_items]
        score tensor stays bounded at any catalog size. Cold items are
        skipped (their lists would be empty noise). Returns items cached."""
        v0 = self._version
        live = np.flatnonzero(
            (self.state.V[:-1] != 0).any(dim=1).cpu().numpy())
        count = 0
        for lo in range(0, len(live), chunk):
            ids = live[lo:lo + chunk]
            items, scores = similar_items(self.state, ids, n, metric)
            for j, iid in enumerate(ids):
                res = items[j][scores[j] > NEG_INF / 2]
                if self.cache.put_if(("sim", int(iid), int(n), metric),
                                     res, lambda: self._version == v0):
                    count += 1
        return count

    def update_state(self, state: MFState):
        """Swap in retrained factors; cached recs are stale -> flush. The
        pending online-update log also flushes: a retrain supersedes it.
        The version is bumped before the flush, so a reader's put_if that
        raced past the bump is cleared by it."""
        self.state = state
        csr, _ = self._index
        self._index = (csr, {})
        self._pending_n = 0
        self._version += 1
        self.cache.invalidate()

    def add_ratings(self, user_id: int, item_ids, ratings,
                    lam: float = 0.05, alpha=None):
        """Online update: record new ratings for an EXISTING user and
        re-solve their factor row in place (fold-in over the user's full
        updated list — exactly the ALS U-step for that user, V fixed).

        Requires train_r at construction. The re-solve fits the residual
        r - (mu + b_i), so biased (SGD) states stay consistent; the user's
        own bias term is left untouched (approximation: only the factor row
        refits). Amortized O(own count) host work per call: updates land in
        a pending log, folded into the base arrays when the log crosses
        max(4096, nnz/100) entries. New users: recommend_cold.
        """
        if self.train_r is None:
            raise ValueError("add_ratings needs train_r at construction")
        user_id = int(user_id)
        if not 0 <= user_id < self.state.n_users:
            raise IndexError(
                f"user {user_id} not in trained factors (0.."
                f"{self.state.n_users - 1}); use recommend_cold for new "
                f"users")
        item_ids = np.asarray(item_ids).reshape(-1)
        ratings = np.asarray(ratings, np.float32).reshape(-1)
        self._check_items(item_ids)
        # re-rating replaces: keep the last value per item within the update
        uniq, inv = np.unique(item_ids, return_inverse=True)
        last = np.zeros(len(uniq), np.int64)
        last[inv] = np.arange(len(item_ids))  # later writes win
        item_ids, ratings = item_ids[last], ratings[last]
        csr, pending = self._index
        prev = pending.get(user_id)
        if prev is not None:
            keep = ~np.isin(prev[0], item_ids)
            item_ids = np.concatenate([prev[0][keep], item_ids])
            ratings = np.concatenate([prev[1][keep], ratings])
            self._pending_n -= len(prev[0])
        # copy-on-write: readers snapshot (csr, pending) as one tuple, so
        # the dict is replaced, never mutated in place
        pending = dict(pending)
        pending[user_id] = (item_ids, ratings)
        self._index = (csr, pending)
        self._pending_n += len(item_ids)
        mi, mr = self._user_items_ratings(user_id)
        row = fold_in_users(self.state, [mi], [mr], lam=lam, alpha=alpha)[0]
        U = self.state.U
        U[user_id] = torch.as_tensor(row, device=U.device).to(U.dtype)
        self._version += 1
        self.cache.invalidate(user_id)
        self._maybe_compact()

    def recommend_cold(self, item_ids, ratings, n: int = 10,
                       lam: float = 0.05, alpha=None):
        """Top-n for a user NOT in the trained factors, from their ad-hoc
        rating list via fold-in (serve/fold_in.py). alpha selects the
        implicit-confidence solve."""
        item_ids = np.asarray(item_ids)
        self._check_items(item_ids)
        items, scores = recommend_fold_in(self.state, [item_ids],
                                          [np.asarray(ratings, np.float32)],
                                          n=n, lam=lam, alpha=alpha)
        return items[0][scores[0] > NEG_INF / 2]

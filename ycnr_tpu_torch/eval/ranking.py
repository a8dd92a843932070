"""Ranking metrics for implicit-feedback models (complements RMSE;
counterpart of ``ycnr_tpu/eval/ranking.py``: the same host NumPy over the
port's ``recommend_users``).

The reference validates with RMSE (SURVEY.md C12), which is meaningful for
explicit ALS/SGD but not for iALS preference scores. Hit-rate@N / recall@N
against the held-out interactions is the standard implicit-feedback check:
for each test interaction (u, i), is i inside u's top-N over unrated items?
Scoring runs on device in user batches; `ranking_metrics_at_n` adds the
standard user-averaged suite (precision/recall/NDCG/MAP@N) on top.
"""

from __future__ import annotations

import numpy as np

from ycnr_tpu_torch.eval.recommend import (recommend_users,
                                           sort_ratings_by_user)
from ycnr_tpu_torch.models.base import MFState


def _sorted_unique(a):
    """``np.unique(a)`` of a non-empty 1-D integer array by one sort (the
    hash-based ``np.unique`` of newer NumPy takes ~0.4 s on a million
    int64 keys, a sort ~0.06 s)."""
    a = np.sort(a)
    return a[np.r_[True, a[1:] != a[:-1]]]


def _sample_users(test_u, test_i, max_users: int, seed: int):
    """Deterministic user subsample shared by all ranking metrics.

    Duplicate (u, i) test interactions are collapsed so the interaction-
    level hit_rate and the user-set metrics agree on one definition."""
    test_u, test_i = np.asarray(test_u), np.asarray(test_i)
    # the distinct pairs in (u, i) order, as np.unique(stack, axis=1) gives
    # them, through one int64 key per pair (its column sort takes seconds
    # on a million pairs)
    dt = np.result_type(test_u, test_i)
    width = int(test_i.max()) + 1
    key = _sorted_unique(test_u.astype(np.int64) * width + test_i)
    test_u, test_i = (key // width).astype(dt), (key % width).astype(dt)
    users = test_u[np.r_[True, test_u[1:] != test_u[:-1]]]  # sorted already
    if len(users) > max_users:
        rng = np.random.default_rng(seed)
        users = rng.choice(users, max_users, replace=False)
        keep = np.isin(test_u, users)
        test_u, test_i = test_u[keep], test_i[keep]
    return users, test_u, test_i


def _rated_lists(train_u, train_i, users, n_users: int):
    """Each sampled user's training items, in rating order (what
    ``recommend_users`` would slice from a user-sorted index). Only the
    sampled users' ratings are sorted, so a metric over a few hundred users
    does not sort the whole training set on every call."""
    train_u = np.asarray(train_u)
    wanted = np.zeros(n_users + 1, bool)
    wanted[users] = True
    keep = np.flatnonzero(wanted[train_u])
    su, si = sort_ratings_by_user(train_u[keep], np.asarray(train_i)[keep])
    probe = np.asarray(users).astype(su.dtype)
    lo = np.searchsorted(su, probe)
    hi = np.searchsorted(su, probe, "right")
    return [si[a:b] for a, b in zip(lo, hi)]


def hit_rate_at_n(state: MFState, train_u, train_i, test_u, test_i,
                  n: int = 10, max_users: int = 2048,
                  seed: int = 0) -> float:
    """Fraction of held-out (u, i) whose item appears in u's masked top-N.

    Evaluates up to max_users distinct test users (sampled deterministically)
    to bound serving cost on large datasets.
    """
    if len(np.asarray(test_u)) == 0:
        return 0.0
    users, test_u, test_i = _sample_users(test_u, test_i, max_users, seed)
    items, _ = recommend_users(
        state, train_u, train_i, users, n,
        rated_lists=_rated_lists(train_u, train_i, users, state.n_users))
    top = {int(u): set(row.tolist()) for u, row in zip(users, items)}
    hits = sum(1 for u, i in zip(test_u, test_i) if int(i) in top[int(u)])
    return hits / len(test_u)


def ranking_metrics_at_n(state: MFState, train_u, train_i, test_u, test_i,
                         n: int = 10, max_users: int = 2048,
                         seed: int = 0) -> dict:
    """User-averaged top-N quality suite over the held-out interactions.

    Per evaluated user u with relevant set R_u (their held-out items) and
    ranked recommendations i_1..i_n (rated items masked):

    * precision@n = |top_n ∩ R_u| / n
    * recall@n    = |top_n ∩ R_u| / |R_u|
    * ndcg@n      = Σ_{p: i_p ∈ R_u} 1/log2(p+1) / Σ_{p≤min(n,|R_u|)} 1/log2(p+1)
    * map@n       = (1/min(n,|R_u|)) Σ_{p: i_p ∈ R_u} precision@p

    plus the interaction-level hit_rate (same definition as hit_rate_at_n)
    and two aggregate list-quality production metrics:

    * coverage@n — |distinct items recommended across evaluated users| /
      n_items (catalog coverage: a popularity-only recommender scores
      ~n/n_items; personalization spreads recommendations over the
      catalog)
    * novelty@n  — mean self-information -log2(count_train(i)/nnz_train)
      of recommended items (Vargas & Castells 2011): higher = the lists
      lean on less-popular items

    All means are over users; up to max_users test users are sampled
    deterministically (the serving pass is the expensive part).
    """
    if len(np.asarray(test_u)) == 0:
        return {"n": n, "users": 0, "hit_rate": 0.0, "precision": 0.0,
                "recall": 0.0, "ndcg": 0.0, "map": 0.0, "coverage": 0.0,
                "novelty": 0.0}
    # recommend_users clamps n to the catalog size internally; mirror the
    # clamp here so np.fromiter(count=n) matches the returned row length
    n = min(int(n), state.n_items)
    users, test_u, test_i = _sample_users(test_u, test_i, max_users, seed)
    items, _ = recommend_users(
        state, train_u, train_i, users, n,
        rated_lists=_rated_lists(train_u, train_i, users, state.n_users))

    rel = {}  # user -> relevant held-out item set
    for u, i in zip(test_u, test_i):
        rel.setdefault(int(u), set()).add(int(i))

    discounts = 1.0 / np.log2(np.arange(2, n + 2))  # positions 1..n
    ideal_cum = np.cumsum(discounts)
    prec = rec = ndcg = ap = 0.0
    hits_total = 0
    for u, row in zip(users, items):
        R = rel[int(u)]
        hit = np.fromiter((int(x) in R for x in row), bool, n)
        h = int(hit.sum())
        hits_total += h
        prec += h / n
        rec += h / len(R)
        ndcg += float(discounts[hit].sum()) / ideal_cum[min(n, len(R)) - 1]
        if h:
            # precision@p at each hit position p (1-based)
            p_at_hit = np.cumsum(hit)[hit] / (np.flatnonzero(hit) + 1)
            ap += float(p_at_hit.sum()) / min(n, len(R))
    m = len(users)
    flat = np.asarray(items).reshape(-1)
    flat = flat[(flat >= 0) & (flat < state.n_items)]  # NEG_INF-tail safe
    counts = np.bincount(np.asarray(train_i), minlength=state.n_items)
    nnz = max(int(counts.sum()), 1)
    novelty = float(np.mean(-np.log2(
        np.maximum(counts[flat], 1) / nnz))) if len(flat) else 0.0
    return {"n": n, "users": int(m),
            "hit_rate": round(hits_total / len(test_u), 6),
            "precision": round(prec / m, 6), "recall": round(rec / m, 6),
            "ndcg": round(ndcg / m, 6), "map": round(ap / m, 6),
            "coverage": round(len(np.unique(flat)) / state.n_items, 6),
            "novelty": round(novelty, 4)}

"""Held-out train/test splits (the port's copy of ``ycnr_tpu/data/split.py``).

Three protocols:

* ``train_test_split`` — uniform random holdout (the default; what the
  reference's random split does).
* ``time_split`` — temporal global holdout: train on the past, test on the
  most recent ``test_fraction`` of interactions by timestamp. The honest
  protocol for "how well would this model have predicted the future"; needs
  the timestamp column (``prepare`` stores it, ``--split time`` selects it).
* ``leave_last_out`` — per-user leave-last-k: each user's k most RECENT
  ratings are held out (users with <= k ratings keep everything in train so
  no train-cold users appear). The classic top-N evaluation protocol.
"""

from __future__ import annotations

import numpy as np


def train_test_split(user_idx, item_idx, rating, test_fraction: float = 0.1,
                     seed: int = 0):
    """Random held-out split of a COO ratings triple.

    Returns ((train_u, train_i, train_r), (test_u, test_i, test_r)).
    """
    n = len(rating)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_test = int(n * test_fraction)
    te, tr = perm[:n_test], perm[n_test:]
    u = np.asarray(user_idx)
    i = np.asarray(item_idx)
    r = np.asarray(rating)
    return (u[tr], i[tr], r[tr]), (u[te], i[te], r[te])


def time_split(user_idx, item_idx, rating, ts, test_fraction: float = 0.1):
    """Temporal global holdout: the most recent test_fraction of rows (by
    timestamp; ties broken by file order via stable sort) are the test set.
    """
    n = len(rating)
    order = np.argsort(np.asarray(ts), kind="stable")
    n_test = int(n * test_fraction)
    tr = order[:n - n_test]
    te = order[n - n_test:]
    u = np.asarray(user_idx)
    i = np.asarray(item_idx)
    r = np.asarray(rating)
    return (u[tr], i[tr], r[tr]), (u[te], i[te], r[te])


def leave_last_out(user_idx, item_idx, rating, ts, k: int = 1):
    """Per-user leave-last-k-out by timestamp.

    Each user's k most recent ratings go to test; users with <= k ratings
    keep all rows in train (a user with an empty train side would be cold —
    untrainable and unmaskable at serving).
    """
    u = np.asarray(user_idx)
    i = np.asarray(item_idx)
    r = np.asarray(rating)
    t = np.asarray(ts)
    order = np.lexsort((t, u))  # user-major, time ascending within user
    us = u[order]
    if len(us) == 0:
        return (u, i, r), (u[:0], i[:0], r[:0])
    starts = np.r_[0, np.flatnonzero(np.diff(us)) + 1]
    cnt = np.diff(np.r_[starts, len(us)])
    pos = np.arange(len(us)) - np.repeat(starts, cnt)
    cnt_b = np.repeat(cnt, cnt)
    from_end = cnt_b - 1 - pos
    is_test = (from_end < k) & (cnt_b > k)
    te, tr = order[is_test], order[~is_test]
    return (u[tr], i[tr], r[tr]), (u[te], i[te], r[te])


def split_coo(u, i, r, ts=None, method: str = "random",
              test_fraction: float = 0.1, seed: int = 0, last_k: int = 1):
    """Dispatch over the three protocols (config data.split)."""
    if method == "random":
        return train_test_split(u, i, r, test_fraction, seed)
    if ts is None:
        raise ValueError(
            f"split={method!r} needs the timestamp column — re-run "
            "`prepare` on a source file that has one (or synthetic, which "
            "stores stream order)")
    if method == "time":
        return time_split(u, i, r, ts, test_fraction)
    if method == "last-out":
        return leave_last_out(u, i, r, ts, k=last_k)
    raise ValueError(f"unknown split method {method!r} "
                     "(random | time | last-out)")

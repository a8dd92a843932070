"""Slow, obviously-correct NumPy oracle for ALS-WR / biased SGD / BPR / iALS:
the port's own copy of ``ycnr_tpu/oracle/numpy_mf.py`` (same arithmetic, held
to the original bit for bit by ``tests/test_torch_host_copies.py``). It is
the independent reference that runs on a machine with PyTorch and no JAX.

This is the SURVEY.md §4 prescription #1: since the reference engine cannot
execute here (no Node.js, empty mount), "match the NodeJS reference"
operationally means "match the published-algorithm math" (SURVEY.md Appendix
A: Zhou et al. ALS-WR; Funk/Koren biased SGD-MF; Hu/Koren/Volinsky iALS). All
math in float64, per-entity Python loops, zero cleverness.
"""

from __future__ import annotations

import numpy as np


def _by_entity(entity_idx, n_entities):
    """indices of ratings grouped per entity (list of arrays)."""
    order = np.argsort(entity_idx, kind="stable")
    sorted_e = entity_idx[order]
    starts = np.searchsorted(sorted_e, np.arange(n_entities))
    ends = np.searchsorted(sorted_e, np.arange(n_entities), side="right")
    return [order[s:t] for s, t in zip(starts, ends)]


def als_wr_epoch(U, V, user_idx, item_idx, rating, lam):
    """One ALS-WR epoch: U-step then V-step (SURVEY.md call stack 3.2).

    Per-user solve (Vr^T Vr + lam * n_u * I) u = Vr^T r_u; weighted-lambda
    regularization multiplies lam by the entity's rating count [ALG].
    Entities with no ratings keep their rows (reference behavior: they are
    never assigned to a worker range with work).
    """
    U = np.array(U, dtype=np.float64)
    V = np.array(V, dtype=np.float64)
    k = U.shape[1]
    for E, F, eidx, oidx in ((U, V, user_idx, item_idx),
                             (V, U, item_idx, user_idx)):
        groups = _by_entity(np.asarray(eidx), E.shape[0])
        for e, g in enumerate(groups):
            n = len(g)
            if n == 0:
                continue
            Fr = F[np.asarray(oidx)[g]]  # [n, k]
            A = Fr.T @ Fr + lam * n * np.eye(k)
            b = Fr.T @ np.asarray(rating, np.float64)[g]
            E[e] = np.linalg.solve(A, b)
    return U, V


def sgd_epoch_batched(U, V, bu, bi, mu, user_idx, item_idx, rating,
                      lam, lr, batch_size, perm):
    """One epoch of *batched* biased SGD with an explicit batch order.

    Device SGD is deterministic mini-batched (SURVEY.md M3): gradients within a
    batch are computed at batch-start parameters and scatter-added. This
    oracle implements exactly those semantics so parity is bitwise-meaningful
    (matching the reference's hogwild races is neither possible nor
    meaningful — SURVEY.md §7 hard parts).

    r_hat = mu + b_u + b_i + p_u . q_i; updates per Appendix A.
    """
    U = np.array(U, np.float64)
    V = np.array(V, np.float64)
    bu = np.array(bu, np.float64)
    bi = np.array(bi, np.float64)
    u_all = np.asarray(user_idx)[perm]
    i_all = np.asarray(item_idx)[perm]
    r_all = np.asarray(rating, np.float64)[perm]
    n = len(r_all)
    for s in range(0, n, batch_size):
        u = u_all[s:s + batch_size]
        i = i_all[s:s + batch_size]
        r = r_all[s:s + batch_size]
        pred = mu + bu[u] + bi[i] + np.einsum("nk,nk->n", U[u], V[i])
        e = r - pred
        dU = np.zeros_like(U)
        dV = np.zeros_like(V)
        dbu = np.zeros_like(bu)
        dbi = np.zeros_like(bi)
        np.add.at(dbu, u, lr * (e - lam * bu[u]))
        np.add.at(dbi, i, lr * (e - lam * bi[i]))
        np.add.at(dU, u, lr * (e[:, None] * V[i] - lam * U[u]))
        np.add.at(dV, i, lr * (e[:, None] * U[u] - lam * V[i]))
        U += dU
        V += dV
        bu += dbu
        bi += dbi
    return U, V, bu, bi


def bpr_epoch_batched(U, V, bi, pos_u, pos_i, neg_j, lam, lr, batch_size,
                      grad_mode="sum"):
    """One epoch of batched BPR-MF (Rendle et al. 2009) with explicit
    triples (beyond-parity: the reference has no ranking trainer; this
    oracle anchors the models/bpr.py implementation).

    pos_u/pos_i are a permutation of the full training COO (every observed
    pair appears once per epoch); neg_j holds the uniformly-sampled
    negative per triple. Triples whose negative is actually rated by the
    user are SKIPPED (zero weight) — the device path masks them via the
    packed rated-bits table, this oracle via an independent set lookup.

    x = U[u].(V[i] - V[j]) + bi[i] - bi[j];  s = sigmoid(-x)
      U[u] += lr (s (V[i]-V[j]) - lam U[u])
      V[i] += lr (s U[u] - lam V[i]);  V[j] += lr (-s U[u] - lam V[j])
      bi[i] += lr (s - lam bi[i]);     bi[j] += lr (-s - lam bi[j])

    grad_mode "sum": duplicates within a batch accumulate (per-sample
    semantics). "mean": each entity's update is divided by its batch
    multiplicity — users by their triple count, items by their total
    appearances across BOTH the positive and negative columns. "emean":
    divided by the EXPECTED multiplicity instead (deterministic weights
    from the training degrees: E[user] = deg_u*B/nnz, E[item] =
    deg_i*B/nnz + B/n_items, clamped >= 1) — the fast device mode
    (models/bpr.expected_weights; the realized counts cost ~6 extra
    random per-row ops per triple on device).
    """
    if grad_mode not in ("sum", "mean", "emean"):
        raise ValueError(f"unknown grad_mode {grad_mode!r}")
    U = np.array(U, np.float64)
    V = np.array(V, np.float64)
    bi = np.array(bi, np.float64)
    pos_u = np.asarray(pos_u)
    pos_i = np.asarray(pos_i)
    neg_j = np.asarray(neg_j)
    rated = set(zip(pos_u.tolist(), pos_i.tolist()))
    n = len(pos_u)
    if grad_mode == "emean":
        # independent recomputation of models/bpr.expected_weights: the
        # positives are one full pass over the training pairs, so their
        # degree counts ARE the training degrees
        n_items = V.shape[0]
        deg_u = np.bincount(pos_u, minlength=U.shape[0])
        deg_i = np.bincount(pos_i, minlength=n_items)
        b_eff = min(batch_size, n)  # a batch holds <= min(B, nnz) rows
        # rounded through float32 like the device's prepare-time vectors
        # (BPRData.wu/wi are f32), so f64 parity stays exact
        ewu = (1.0 / np.maximum(deg_u * (b_eff / n), 1.0)
               ).astype(np.float32).astype(np.float64)
        ewi = (1.0 / np.maximum(
            deg_i * (b_eff / n) + b_eff / n_items, 1.0)
        ).astype(np.float32).astype(np.float64)
    for s0 in range(0, n, batch_size):
        u = pos_u[s0:s0 + batch_size]
        i = pos_i[s0:s0 + batch_size]
        j = neg_j[s0:s0 + batch_size]
        m = np.asarray([(a, b) not in rated
                        for a, b in zip(u.tolist(), j.tolist())], np.float64)
        x = (np.einsum("nk,nk->n", U[u], V[i] - V[j]) + bi[i] - bi[j])
        s = m / (1.0 + np.exp(x))  # sigmoid(-x), masked
        if grad_mode == "mean":
            cu = np.zeros(U.shape[0])
            np.add.at(cu, u, m)
            ci = np.zeros(V.shape[0])
            np.add.at(ci, i, m)
            np.add.at(ci, j, m)
            wu = m / np.maximum(cu[u], 1.0)
            wi = m / np.maximum(ci[i], 1.0)
            wj = m / np.maximum(ci[j], 1.0)
        elif grad_mode == "emean":
            wu = m * ewu[u]
            wi = m * ewi[i]
            wj = m * ewi[j]
        else:
            wu = wi = wj = m
        dU = np.zeros_like(U)
        dV = np.zeros_like(V)
        dbi = np.zeros_like(bi)
        np.add.at(dU, u, lr * wu[:, None] * (s[:, None] * (V[i] - V[j])
                                             - lam * U[u]))
        np.add.at(dV, i, lr * wi[:, None] * (s[:, None] * U[u] - lam * V[i]))
        np.add.at(dV, j, lr * wj[:, None] * (-s[:, None] * U[u]
                                             - lam * V[j]))
        np.add.at(dbi, i, lr * wi * (s - lam * bi[i]))
        np.add.at(dbi, j, lr * wj * (-s - lam * bi[j]))
        U += dU
        V += dV
        bi += dbi
    return U, V, bi


def ials_epoch(U, V, user_idx, item_idx, rating, lam, alpha):
    """One implicit-ALS epoch (Hu/Koren/Volinsky) on binarized preferences.

    c_ui = 1 + alpha * r_ui, p_ui = 1[r_ui > 0]; per-user solve
    (V^T V + V^T (C_u - I) V + lam I) x_u = V^T C_u p_u with the global Gram
    precomputed once per sweep (SURVEY.md C11 / M4).
    """
    U = np.array(U, np.float64)
    V = np.array(V, np.float64)
    k = U.shape[1]
    for E, F, eidx, oidx in ((U, V, user_idx, item_idx),
                             (V, U, item_idx, user_idx)):
        G = F.T @ F  # global Gram, once per sweep
        groups = _by_entity(np.asarray(eidx), E.shape[0])
        for e, g in enumerate(groups):
            if len(g) == 0:
                continue  # cold entity keeps its row
            Fr = F[np.asarray(oidx)[g]]
            w = alpha * np.asarray(rating, np.float64)[g]  # c - 1
            A = G + Fr.T @ (w[:, None] * Fr) + lam * np.eye(k)
            b = Fr.T @ (1.0 + w)  # c * p with p = 1 on observed
            E[e] = np.linalg.solve(A, b)
    return U, V


def predict(U, V, bu, bi, mu, user_idx, item_idx):
    base = mu + (bu[user_idx] if bu is not None else 0.0) + (
        bi[item_idx] if bi is not None else 0.0)
    return base + np.einsum("nk,nk->n", U[user_idx], V[item_idx])


def rmse(U, V, user_idx, item_idx, rating, bu=None, bi=None, mu=0.0):
    e = np.asarray(rating, np.float64) - predict(U, V, bu, bi, mu,
                                                 user_idx, item_idx)
    return float(np.sqrt(np.mean(e * e))) if len(e) else 0.0


def topn(U, V, rated_by_user, u, n, bu=None, bi=None, mu=0.0):
    """Masked top-N for one user (SURVEY.md call stack 3.5)."""
    scores = mu + V @ U[u]
    if bi is not None:
        scores = scores + bi
    if bu is not None:
        scores = scores + bu[u]
    scores = scores.astype(np.float64).copy()
    scores[np.asarray(rated_by_user, dtype=np.int64)] = -np.inf
    idx = np.argpartition(-scores, min(n, len(scores) - 1))[:n]
    return idx[np.argsort(-scores[idx])]

"""Fold-in: factors for new or updated users at serving time, without
retraining (counterpart of ``ycnr_tpu/serve/fold_in.py``).

Holding the trained item factors V fixed, solve the same per-user normal
equations the ALS U-step solves, for ad-hoc rating lists:

    explicit (ALS-WR):  (V_r^T V_r + lam n I) u = V_r^T (r - mu - b_i)
    implicit (iALS):    (V^T V + alpha V_r^T diag(r) V_r + lam I) u
                            = V_r^T (1 + alpha r)

and recommend from the folded rows. Rating lists are padded to power-of-
two widths with index n_items, which gathers V's zero row. On CUDA the
gather is the row-gather kernel and the solve is K1; on the CPU both are
their plain versions.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ycnr_tpu_torch.models.base import MFState
from ycnr_tpu_torch.ops.fused_topn import NEG_INF
from ycnr_tpu_torch.ops.row_gather import row_gather
from ycnr_tpu_torch.ops.spd_solve import spd_solve


def _fold_in(V, G, item_idx, rating, bias, mu, lam, alpha,
             implicit: bool) -> torch.Tensor:
    """Solve the per-user normal equations for padded rating lists.

    V [n_items+1, k] (zero last row); G [k, k] the cached base Gram (read
    on the implicit path only); item_idx [m, L] padded with n_items;
    rating [m, L] padded with 0; bias [n_items+1] the other side's bias
    terms (zero for ALS/iALS states). Returns factors [m, k].
    """
    Vr = row_gather(V, item_idx)  # [m, L, k]; padding rows are zero
    k = V.shape[1]
    eye = torch.eye(k, dtype=V.dtype, device=V.device)
    mask = (item_idx < V.shape[0] - 1).to(V.dtype)
    if implicit:
        # base Gram over all items + confidence correction over rated ones
        A = (G[None] + alpha * torch.einsum("mlk,ml,mle->mke", Vr, rating,
                                            Vr) + lam * eye)
        b = torch.einsum("mlk,ml->mk", Vr, 1.0 + alpha * rating)
    else:
        # fit the residual r - (mu + b_i): serving re-adds mu and the
        # biases (zero for ALS/iALS states); masked so padding stays 0
        resid = (rating - (mu + bias[item_idx.long()])) * mask
        n_r = mask.sum(1)
        A = (torch.einsum("mlk,mle->mke", Vr, Vr)
             + (lam * n_r + (n_r == 0))[:, None, None] * eye)
        b = torch.einsum("mlk,ml->mk", Vr, resid)
    A = 0.5 * (A + A.transpose(-1, -2))  # K1 reads both triangles
    return spd_solve(A.contiguous(), b.contiguous())


# id(V) -> (V, V._version, G); V is kept alive so its id stays unique
_GRAM_CACHE: dict = {}


def _item_gram(V: torch.Tensor) -> torch.Tensor:
    """Cached base Gram V^T V (without the zero row) for the implicit
    solve: it changes only when a new state is published. The port's
    phases update factors in place, so an entry is keyed by the tensor
    and its version counter, which every in-place write advances."""
    key = id(V)
    hit = _GRAM_CACHE.get(key)
    if hit is not None and hit[0] is V and hit[1] == V._version:
        return hit[2]
    G = V[:-1].T @ V[:-1]
    if len(_GRAM_CACHE) >= 8:  # a serving process holds a handful of states
        _GRAM_CACHE.clear()
    _GRAM_CACHE[key] = (V, V._version, G)
    return G


def _np_dtype(t: torch.Tensor):
    return np.float64 if t.dtype == torch.float64 else np.float32


def _pad_lists(item_lists, rating_lists, n_items, dtype):
    m = len(item_lists)
    width = max(8, max((len(x) for x in item_lists), default=1))
    width = 1 << int(np.ceil(np.log2(width)))
    idx = np.full((m, width), n_items, np.int32)
    r = np.zeros((m, width), dtype)
    for j, (ii, rr) in enumerate(zip(item_lists, rating_lists)):
        idx[j, : len(ii)] = ii
        r[j, : len(rr)] = rr
    return idx, r


def _fold_in_fixed(F, bias, mu, idx, r, lam, alpha) -> np.ndarray:
    """Fold-in against the fixed factor F (V for users, U for items)."""
    dev = F.device
    implicit = alpha is not None
    G = _item_gram(F) if implicit else F.new_zeros(0, 0)
    rows = _fold_in(F, G, torch.as_tensor(idx, device=dev),
                    torch.as_tensor(r, device=dev).to(F.dtype), bias, mu,
                    float(lam), float(alpha or 0.0), implicit)
    return rows.cpu().numpy()


def fold_in_users(state: MFState, item_lists: Sequence,
                  rating_lists: Sequence, lam: float = 0.05,
                  alpha: Optional[float] = None) -> np.ndarray:
    """Factors [m, k] for m ad-hoc users given their (item_ids, ratings)
    lists. alpha=None: explicit ALS-WR solve; alpha set: implicit iALS
    confidence solve."""
    idx, r = _pad_lists(item_lists, rating_lists, state.n_items,
                        _np_dtype(state.U))
    return _fold_in_fixed(state.V, state.bi, state.mu, idx, r, lam, alpha)


def fold_in_items(state: MFState, user_lists: Sequence,
                  rating_lists: Sequence, lam: float = 0.05,
                  alpha: Optional[float] = None) -> np.ndarray:
    """Factors [m, k] for m ad-hoc items from (user_ids, ratings) lists:
    the symmetric V-step solve against the trained user factors."""
    idx, r = _pad_lists(user_lists, rating_lists, state.n_users,
                        _np_dtype(state.V))
    return _fold_in_fixed(state.U, state.bu, state.mu, idx, r, lam, alpha)


def _topn_rows(rows, V, bi, mu, rated_padded, n: int):
    """Top-n over the catalog for each row, its rated items and the trash
    column masked. Returns (scores [m, n], items [m, n])."""
    n_items = V.shape[0] - 1
    scores = mu + bi[None, :] + rows @ V.T
    m, L = rated_padded.shape
    b = torch.arange(m, device=scores.device).repeat_interleave(L)
    scores[b, rated_padded.reshape(-1).long()] = NEG_INF
    scores[:, n_items] = NEG_INF
    return torch.topk(scores, n, dim=1)


def recommend_fold_in(state: MFState, item_lists: Sequence,
                      rating_lists: Sequence, n: int = 10,
                      lam: float = 0.05, alpha: Optional[float] = None):
    """Top-N for ad-hoc users straight from their rating lists (fold-in +
    masked top-k). Returns (items [m, n], scores [m, n]) as NumPy; the
    users' own rated items are masked as on the trained serving path."""
    n = min(int(n), state.n_items)  # top-k past the catalog size fails
    idx, r = _pad_lists(item_lists, rating_lists, state.n_items,
                        _np_dtype(state.U))
    rows = _fold_in_fixed(state.V, state.bi, state.mu, idx, r, lam, alpha)
    dev = state.V.device
    top_s, top_i = _topn_rows(torch.as_tensor(rows, device=dev).to(
        state.V.dtype), state.V, state.bi, state.mu,
        torch.as_tensor(idx, device=dev), n)
    return top_i.cpu().numpy(), top_s.cpu().numpy()

"""Top-N recommendation serving (counterpart of ``ycnr_tpu/eval/recommend.py``).

scores = mu + b_u + b_i + U[u] . V^T with rated items masked to NEG_INF,
then top-n:

* ``recommend_all`` walks the user-major ``BlockedCSR`` layout block by
  block (rated masks come from the layout) — the bulk path; ``fused`` and
  ``fused32`` go through K2 (``ops/fused_topn.py``).
* ``recommend_users`` serves an explicit user list; rated lists are sliced
  on the host and padded to one rectangle.

``build_rated_bits`` and ``top_popular`` are NumPy copies of the JAX
package's: its module imports JAX, which the port does not.
"""

from __future__ import annotations

import numpy as np
import torch

from ycnr_tpu_torch.models.base import MFState, device_layout
from ycnr_tpu_torch.ops.fused_topn import (
    NEG_INF,
    fused_supported,
    fused_topn_blocks,
)
from ycnr_tpu_torch.ops.layout import BlockedCSR
from ycnr_tpu_torch.utils.profiling import span


def overfetch_n(n: int, n_extra: int) -> int:
    """Next power of two >= n + n_extra — the exclusion over-fetch width."""
    return 1 << max(int(n) + int(n_extra) - 1, 0).bit_length()


def use_fused(method: str, n_items: int, n: int, device) -> bool:
    """Whether a serving pass with this ``method`` goes through K2.

    A catalog too small for the two-level select (``fused_supported``) is
    served by the exact scorer when the factors live on the CPU, as the JAX
    package does; on the card it raises, so a pass asked for K2 never runs
    without it."""
    if method == "exact":
        return False
    if fused_supported(n_items, n):
        return True
    if torch.device(device).type == "cpu":
        return False
    raise ValueError(
        f"method {method!r}: {n_items} items are too few for the fused "
        f"top-{n} select; ask for the exact scorer")


def top_popular(item_idx, n_items: int, n: int) -> np.ndarray:
    """Top-n item ids by rating count — the zero-history fallback of
    ``serve.engine.Recommender.popular``. Host-side: a bincount over nnz
    beats shipping it to the device. Never-rated items are excluded, so
    fewer than n ids may return."""
    counts = np.bincount(np.asarray(item_idx), minlength=int(n_items))
    n_eff = min(int(n), len(counts))
    if n_eff <= 0:
        return np.empty(0, np.int64)
    top = np.argpartition(-counts, n_eff - 1)[:n_eff]
    top = top[np.argsort(-counts[top], kind="stable")].astype(np.int64)
    return top[counts[top] > 0]


def build_rated_bits(layout: BlockedCSR, n_items: int) -> np.ndarray:
    """The rated-items mask as packed uint32 words, host-side.

    [..., U_B, W] with W = 4 * ceil((n_items + 1) / 128), so W * 32 is a
    whole number of 128-item segments. Bit (j & 31) of word (j >> 5) marks
    item j; the trash column ``n_items`` and every pad column are always
    set. Accepts single ([NB, C_B, L]) or stacked ([D, NB, C_B, L]) layouts.
    """
    oi = np.asarray(layout.other_idx)
    seg = np.asarray(layout.chunk_seg)
    U_B = layout.entity_ids.shape[-1]
    lead = oi.shape[:-2]
    C_B, L = oi.shape[-2:]
    W = 4 * (-(-(n_items + 1) // 128))
    oi2 = oi.reshape(-1, C_B, L)
    seg2 = seg.reshape(-1, C_B)
    P_ = oi2.shape[0]
    pref = np.arange(P_, dtype=np.int64)[:, None]
    slot = np.minimum(seg2, U_B - 1).astype(np.int64)  # [P, C_B]
    key = ((pref * U_B + slot)[:, :, None] * W
           + (oi2 >> 5).astype(np.int64))  # [P, C_B, L]
    val = (np.uint32(1) << (oi2 & 31).astype(np.uint32))
    real = (seg2 < U_B)[:, :, None] & np.ones((1, 1, L), bool)
    key = key[real]  # sorted: blocks asc, slots asc, items asc per entity
    val = val[real]
    out = np.zeros(P_ * U_B * W, np.uint32)
    if key.size:
        starts = np.flatnonzero(np.r_[True, np.diff(key) != 0])
        out[key[starts]] = np.bitwise_or.reduceat(val, starts)
    out = out.reshape(*lead, U_B, W)
    out[..., :, n_items >> 5] |= ~np.uint32(
        (np.uint32(1) << np.uint32(n_items & 31)) - 1)
    out[..., :, (n_items >> 5) + 1:] = np.uint32(0xFFFFFFFF)
    return out


def bits_tensor(rated_bits: np.ndarray, device) -> torch.Tensor:
    """uint32 words -> an int32 tensor of the same bits (torch has few
    uint32 ops; ``(w >> s) & 1`` reads bit s correctly either way)."""
    return torch.as_tensor(np.ascontiguousarray(rated_bits).view(np.int32),
                           device=device)


def _pad_items(V, bi, W):
    """Pad the item factor/bias to the bitmask's W*32 columns (zero rows;
    the bits mark every column >= n_items)."""
    add = W * 32 - V.shape[0]
    if add <= 0:
        return V, bi
    Vp = torch.cat([V, V.new_zeros(add, V.shape[1])])
    bip = torch.cat([bi, bi.new_zeros(add)])
    return Vp, bip


def _mask_scores_bits(scores, bits):
    """scores [U_B, M] with bit-marked positions set to NEG_INF."""
    M = scores.shape[1]
    j = torch.arange(M, device=scores.device)
    rated = ((bits[:, j >> 5] >> (j & 31)) & 1) != 0
    return torch.where(rated, torch.full_like(scores, NEG_INF), scores)


def _segment_topn(scores, n: int, seg_len: int = 128):
    """Exact top-n without a full-width sort: every global top-n element
    lives in a segment whose max is among the n largest segment maxima.
    Ties at the n-th value may resolve to another equal-scored item than a
    full sort would."""
    U_B, M = scores.shape
    S = -(-M // seg_len)
    if S <= n:  # tiny item spaces: a plain sort is cheap and exact
        v, i = torch.topk(scores, n, dim=1)
        return i.to(torch.int32), v
    if S * seg_len != M:
        scores = torch.nn.functional.pad(scores, (0, S * seg_len - M),
                                         value=NEG_INF)
    s3 = scores.reshape(U_B, S, seg_len)
    _, top_seg = torch.topk(s3.amax(dim=2), n, dim=1)  # [U_B, n]
    cand = torch.gather(s3, 1, top_seg[:, :, None].expand(-1, -1, seg_len))
    v, loc = torch.topk(cand.reshape(U_B, n * seg_len), n, dim=1)
    items = torch.gather(top_seg, 1, loc // seg_len) * seg_len \
        + loc % seg_len
    return items.to(torch.int32), v


def topn_block(U, V, bu, bi, mu, entity_ids, n: int, rated_bits=None,
               chunk_seg=None, other_idx=None):
    """Masked top-n for one layout block.

    rated_bits [U_B, W] int32: the fast path (bit unpack + exact segment
    top-n). None takes the scatter + full top-k path, which needs the
    block's ``chunk_seg`` and ``other_idx``.
    """
    n_items = V.shape[0] - 1
    rows = U[entity_ids]  # [U_B, k]
    scores = (mu + bu[entity_ids][:, None] + bi[None, :] + rows @ V.T)
    if rated_bits is not None:
        return _segment_topn(_mask_scores_bits(scores, rated_bits), n)
    U_B = entity_ids.shape[0]
    slot = torch.clamp(chunk_seg, max=U_B - 1)  # padding chunks -> safe row
    flat_rows = torch.repeat_interleave(slot, other_idx.shape[1])
    scores[flat_rows, other_idx.reshape(-1)] = NEG_INF  # pad -> col n_items
    scores[:, n_items] = NEG_INF  # trash column off
    top_s, top_i = torch.topk(scores, n, dim=1)
    return top_i.to(torch.int32), top_s


def _topn_blocks(state: MFState, layout: BlockedCSR, n: int,
                 rated_bits=None):
    """[NB, U_B, n] top items + scores per entity slot, rated masked.

    layout: a BlockedCSR of tensors on the state's device; rated_bits
    [NB, U_B, W] int32 tensor (see ``bits_tensor``) selects the fast path.
    """
    ids, sc = [], []
    if rated_bits is None:
        for b in range(layout.other_idx.shape[0]):
            i, s = topn_block(state.U, state.V, state.bu, state.bi, state.mu,
                              layout.entity_ids[b].long(), n,
                              chunk_seg=layout.chunk_seg[b].long(),
                              other_idx=layout.other_idx[b].long())
            ids.append(i)
            sc.append(s)
        return torch.stack(ids), torch.stack(sc)
    # pad V/bi to whole segments once, so block scores come out aligned
    Vp, bip = _pad_items(state.V, state.bi, rated_bits.shape[-1])
    for b in range(rated_bits.shape[0]):
        i, s = topn_block(state.U, Vp, state.bu, bip, state.mu,
                          layout.entity_ids[b].long(), n,
                          rated_bits=rated_bits[b])
        ids.append(i)
        sc.append(s)
    return torch.stack(ids), torch.stack(sc)


def recommend_all(state: MFState, user_layout: BlockedCSR, n: int = 10,
                  rated_bits=None, method: str = "exact"):
    """Top-N for every user with >= 1 training rating.

    Returns (user_ids [m], item_ids [m, n], scores [m, n]) as NumPy.
    user_layout: host (NumPy) BlockedCSR from ``build_blocked_csr``;
    rated_bits: its ``build_rated_bits`` words, built here when None.

    method: "exact" = f32 (the state's dtype) end to end. "fused" = K2
    (``ops/fused_topn.py``): bf16 inputs, exact segment choice from f32
    maxima, within-segment order and returned scores at bf16 precision.
    "fused32" keeps the score buffer f32 (bf16 inputs only). A catalog too
    small for the two-level select is served "exact" on the CPU and
    raises on the card (``use_fused``).

    Spans (``utils/profiling.span``): ``pass`` around the call, and in it
    ``upload`` (the rated bits to the device), the fused path's ``score``
    and ``select`` (``ops/fused_topn.fused_topn_core``) and ``to_host``.
    """
    with span("pass"):
        n = min(int(n), state.n_items)  # top-k past the catalog size fails
        if rated_bits is None:
            rated_bits = build_rated_bits(user_layout, state.n_items)
        dev = state.U.device
        with span("upload"):
            bits = bits_tensor(rated_bits, dev)
        eids = np.asarray(user_layout.entity_ids)
        if use_fused(method, state.n_items, n, dev):
            ids, sc = fused_topn_blocks(
                state, torch.as_tensor(eids, device=dev), bits, n,
                score_bf16=(method != "fused32"))
        else:
            ids, sc = _topn_blocks(state, device_layout(
                user_layout, state.U.dtype, dev), n, bits)
        eids = eids.reshape(-1)
        with span("to_host"):
            ids = ids.cpu().numpy().reshape(-1, n)
            sc = sc.cpu().numpy().reshape(-1, n)
        real = eids < state.n_users
        return eids[real], ids[real], sc[real]


def _topn_users(state: MFState, user_ids, rated_padded, n: int):
    n_items = state.V.shape[0] - 1
    rows = state.U[user_ids]
    scores = (state.mu + state.bu[user_ids][:, None] + state.bi[None, :]
              + rows @ state.V.T)
    b = torch.arange(rated_padded.shape[0], device=scores.device)
    scores[b[:, None].expand_as(rated_padded).reshape(-1),
           rated_padded.reshape(-1)] = NEG_INF
    scores[:, n_items] = NEG_INF
    return torch.topk(scores, n, dim=1)


def sort_ratings_by_user(train_u, train_i):
    """One-time host index for serving: (sorted_u, sorted_i)."""
    train_u = np.asarray(train_u)
    train_i = np.asarray(train_i)
    order = np.argsort(train_u, kind="stable")
    return train_u[order], train_i[order]


def recommend_users(state: MFState, train_u, train_i, user_ids, n: int = 10,
                    sorted_index=None, rated_lists=None, min_width=None):
    """Top-N for an explicit user list. Rated lists are gathered host-side
    (or given as ``rated_lists``, one array per user) and padded with
    n_items to a power-of-two width of at least ``min_width``.
    Returns (item_ids [B, n], scores [B, n]) as NumPy."""
    n = min(int(n), state.n_items)
    user_ids = np.asarray(user_ids, np.int64)
    if rated_lists is not None:
        lists = list(rated_lists)
    else:
        su, si = sorted_index if sorted_index is not None else (
            sort_ratings_by_user(train_u, train_i))
        # probe in the index's own dtype: an id of another dtype makes
        # NumPy convert the whole sorted index on every probe
        probe = user_ids.astype(su.dtype)
        lo = np.searchsorted(su, probe)
        hi = np.searchsorted(su, probe, "right")
        lists = [si[a:b] for a, b in zip(lo, hi)]
    width = max(8, max((len(x) for x in lists), default=1), min_width or 0)
    width = 1 << int(np.ceil(np.log2(width)))
    rated = np.full((len(user_ids), width), state.n_items, np.int64)
    for j, x in enumerate(lists):
        rated[j, : len(x)] = x
    dev = state.U.device
    top_s, top_i = _topn_users(state, torch.as_tensor(user_ids, device=dev),
                               torch.as_tensor(rated, device=dev), n)
    return top_i.to(torch.int32).cpu().numpy(), top_s.cpu().numpy()

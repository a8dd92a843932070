"""Bucketed slot-major layout: the segsum-free fast path for ALS/iALS
(the port's copy of ``ycnr_tpu/ops/bucketed.py``, NumPy only; it gives the
same arrays as the original).

This layout removes the segment reduction of the blocked layout over
per-chunk Gram tensors ([C_B, k, k]) entirely:

* entities are grouped by a row-count rung ladder ({8, 12, 16, 24, ...});
  inside a group every entity owns exactly R rating slots (its rung), so
  the per-entity Gram is a single batched product `urk,urm->ukm` over
  the R axis — no chunk_seg, no scatter-add;
* groups are split into fixed-size blocks ([NB, NE_b, R]) and walked block
  by block, the same streaming structure as BlockedCSR (bounded device
  memory for the gathered rows);
* the zero-row padding trick is identical: padding slots gather the all-zero
  trailing row of the other factor and contribute nothing.

Cost: pow2 rounding pads up to 2x the chunk count of the largest entities
(power-law tail), typically ~15-25% extra gathered bytes overall — far
cheaper than the segment_sum it replaces. BlockedCSR remains the general
layout (serving masks, sharded stacking); this is the single-chip solve
accelerator.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np


class BucketGroup(NamedTuple):
    """One rung bucket, blocked for scanning. All entities in the group
    own exactly R rating slots (R = the group's ladder rung)."""

    other_idx: np.ndarray  # [NB, NE_b, R] int32 (pad -> n_other)
    rating: np.ndarray  # [NB, NE_b, R] float32 (pad -> 0)
    entity_ids: np.ndarray  # [NB, NE_b] int32 (pad -> n_entities)
    entity_cnt: np.ndarray  # [NB, NE_b] float32 (pad -> 0)

    @property
    def rows(self) -> int:
        return self.other_idx.shape[2]


BucketedCSR = Tuple[BucketGroup, ...]


def entity_order(entity_idx: np.ndarray, other_idx: np.ndarray,
                 n_other: int) -> np.ndarray:
    """The (entity, other) order of a COO, ties kept in input order:
    ``np.lexsort((other_idx, entity_idx))``, computed as one stable
    argsort of the combined int64 key (the same permutation, about twice
    as fast). Indices are non-negative int64, checked by the callers."""
    return np.argsort(entity_idx * (n_other + 1) + other_idx, kind="stable")


def _dp_rungs(active_counts: np.ndarray, max_groups: int,
              n_cand: int = 512) -> np.ndarray:
    """Per-entity rung heights: the smallest chosen height >= the entity's
    rating count, with at most max_groups distinct heights chosen to
    minimize the total padded slots (exact partition DP over <=n_cand
    candidate heights)."""
    counts = np.sort(active_counts.astype(np.int64))
    distinct = np.unique(counts)
    if len(distinct) > n_cand:
        sel = np.linspace(0, len(distinct) - 1, n_cand).astype(int)
        cand = distinct[sel]
    else:
        cand = distinct
    # round heights up to the 8-row sublane; keep them >= the counts they
    # must cover and always include a top rung covering the max
    cand = np.unique(-(-cand // 8) * 8)
    L = len(cand)
    cum = np.searchsorted(counts, cand, side="right")  # entities covered
    camf = cand.astype(np.float64)
    # f[i] = min slots covering entities with count <= cand[i], top rung
    # cand[i]; choice[g][i] = previous rung index (or -1)
    f = camf * cum
    choices = [np.full(L, -1, np.int64)]
    G = max(1, max_groups)
    for _ in range(1, G):
        nf = f.copy()  # not using the extra rung is always allowed
        ch = np.full(L, -1, np.int64)
        for i in range(1, L):
            vals = f[:i] + camf[i] * (cum[i] - cum[:i])
            j = int(np.argmin(vals))
            if vals[j] < nf[i]:
                nf[i] = vals[j]
                ch[i] = j
        # keep the no-op choice marker where the previous layer won
        ch[nf == f] = -2  # -2 = inherit previous layer's traceback
        f = nf
        choices.append(ch)
    # trace back the chosen heights from the top rung
    heights = []
    g, i = len(choices) - 1, L - 1
    while i >= 0:
        ch = choices[g][i]
        if ch == -2 and g > 0:
            g -= 1
            continue
        heights.append(int(cand[i]))
        if ch < 0:
            break
        i, g = int(ch), g - 1
    heights = np.asarray(sorted(heights), np.int64)
    return heights[np.searchsorted(heights, active_counts)]


def _group_shape(R: int, n_e: int, rank_hint: int,
                 target_bytes: int) -> tuple:
    """(nb, ne_b): blocks sized for ~target_bytes of gathered [NE_b, R, k]
    fp32, BALANCED across the group (a fixed block size would leave the
    last block mostly dummy entities)."""
    ne_target = max(8, target_bytes // (R * rank_hint * 4))
    nb = max(1, -(-n_e // ne_target))
    ne_b = int(-(-(-(-n_e // nb)) // 8) * 8)  # ceil(n_e/nb) to mult of 8
    return nb, ne_b


def build_bucketed(
    entity_idx, other_idx, rating, n_entities: int, n_other: int,
    chunk_len: int = 32, rank_hint: int = 64,
    target_bytes: int = 192 * 2**20, max_groups: int = 16,
) -> BucketedCSR:
    """Pack entities into rectangular row-ladder buckets.

    ``chunk_len`` is accepted for signature symmetry with
    ``build_blocked_csr`` but IGNORED here: the original pow2-chunk
    grouping (R = nch * L) cost ~20% fill on power-law tails and was
    replaced by the row-granular rung ladder below, which has no chunk
    dimension. Tune ``max_groups`` (program size / fill) and
    ``target_bytes`` (block streaming granularity) instead.
    """
    entity_idx = np.asarray(entity_idx, dtype=np.int64)
    o_all = np.asarray(other_idx, dtype=np.int64)
    r_all = np.asarray(rating, dtype=np.float32)
    if not (len(entity_idx) == len(o_all) == len(r_all)):
        raise ValueError("COO arrays must share length")
    if len(entity_idx) and (entity_idx.max() >= n_entities
                            or o_all.max() >= n_other
                            or entity_idx.min() < 0 or o_all.min() < 0):
        raise ValueError("index out of range")

    # sort by (entity, other): within-entity item order is ascending, which
    # improves DRAM locality of the device gather at zero build cost
    order = entity_order(entity_idx, o_all, n_other)
    o_sorted = np.ascontiguousarray(o_all[order], np.int32)
    r_sorted = np.ascontiguousarray(r_all[order], np.float32)
    counts = np.bincount(entity_idx, minlength=n_entities).astype(np.int64)
    starts = np.zeros(n_entities + 1, np.int64)
    np.cumsum(counts, out=starts[1:])

    active = np.nonzero(counts)[0]
    # Choose at most max_groups rung heights by exact DP over candidate
    # heights (quantiles of the distinct rating counts, rounded up to a
    # multiple of 8): minimize total padded slots subject to the group
    # budget.
    rung = _dp_rungs(counts[active], max_groups)

    groups = []
    for p in np.unique(rung):
        ents = active[rung == p]
        R = int(p)
        n_e = len(ents)
        nb, ne_b = _group_shape(R, n_e, rank_hint, target_bytes)

        oi = np.full((nb * ne_b, R), n_other, np.int32)
        rr = np.zeros((nb * ne_b, R), np.float32)
        eid = np.full(nb * ne_b, n_entities, np.int32)
        cnt = np.zeros(nb * ne_b, np.float32)
        eid[:n_e] = ents
        cnt[:n_e] = counts[ents]
        # fill rows, padding pre-filled: one vectorized copy (the JAX
        # package copies entity by entity, in C++ or NumPy; the arrays are
        # the same). Slot q of entity j reads sorted rating starts[e_j] + q.
        cj = counts[ents]
        row = np.repeat(np.arange(n_e), cj)
        col = np.arange(int(cj.sum()), dtype=np.int64) - np.repeat(
            np.cumsum(cj) - cj, cj)
        src = starts[ents][row] + col
        oi[row, col] = o_sorted[src]
        rr[row, col] = r_sorted[src]
        groups.append(BucketGroup(
            oi.reshape(nb, ne_b, R), rr.reshape(nb, ne_b, R),
            eid.reshape(nb, ne_b), cnt.reshape(nb, ne_b)))
    return tuple(groups)


def bucketed_stats(groups: BucketedCSR, nnz: int) -> dict:
    slots = sum(int(g.other_idx.size) for g in groups)
    return {
        "n_groups": len(groups),
        "rows_per_group": [g.rows for g in groups],
        "blocks_per_group": [g.other_idx.shape[0] for g in groups],
        "padded_slots": slots,
        "nnz": nnz,
        "fill": nnz / slots if slots else 0.0,
    }

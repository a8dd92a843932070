"""Blocked chunked-CSR layout: the device-resident sparse ratings format
(the port's copy of ``ycnr_tpu/ops/layout.py``, NumPy only; it gives the
same arrays as the original).

A *static-shape* layout living in device memory:

* Each entity's (user's or item's) rating list is split into chunks of fixed
  length ``L`` (``chunk_len``). A mega-entity simply owns several chunks —
  the moral equivalent of the reference's portioned streaming, and the
  "blockwise" answer to the long-dimension scaling question (SURVEY.md §5).
* Chunks are packed into blocks of exactly ``C_B`` chunks (``block_chunks``),
  never splitting an entity across blocks, so one block can be solved with one
  batched Cholesky after a local ``segment_sum`` (chunk -> local entity slot).
* **Zero-row padding trick**: padding positions point at index ``n_other``
  (one past the last real row) of the *other* factor matrix, whose padded
  ``[n_other+1, k]`` form keeps that trailing row at exactly zero. Gathers of
  padding therefore contribute 0 to every Gram matrix and right-hand side — no
  mask arrays, no masked loads.
* Padding entity slots point at entity row ``n_entities`` (a trash row); the
  solver writes zeros there (their normal equations are the guarded identity
  system), so the trash row *stays* zero and the trick self-maintains.

Shapes (NB = number of blocks, U_B = entity slots per block):
    other_idx   [NB, C_B, L]  int32   column index into the other factor
    rating      [NB, C_B, L]  float32 rating value (0 at padding)
    chunk_seg   [NB, C_B]     int32   local entity slot of each chunk
                                       (U_B for padding chunks)
    entity_ids  [NB, U_B]     int32   global entity row per local slot
                                       (n_entities for padding slots)
    entity_cnt  [NB, U_B]     float32 true rating count n_e per slot (0 pad)

C_B (chunk budget) and U_B (entity budget) are independent: a block closes
when either fills. Sizing U_B near C_B * (entities per chunk) keeps the
batched Cholesky batch nearly dense instead of mostly padding slots (the
per-slot solve costs O(k^3) whether or not the slot is real).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from ycnr_tpu_torch.ops.bucketed import entity_order


class BlockedCSR(NamedTuple):
    """Device-friendly blocked chunked-CSR. All fields are arrays (pytree)."""

    other_idx: np.ndarray  # [NB, C_B, L] int32
    rating: np.ndarray  # [NB, C_B, L] float32
    chunk_seg: np.ndarray  # [NB, C_B] int32 (slot in [0, U_B); U_B = pad)
    entity_ids: np.ndarray  # [NB, U_B] int32
    entity_cnt: np.ndarray  # [NB, U_B] float32

    @property
    def n_blocks(self) -> int:
        return self.other_idx.shape[0]

    @property
    def block_chunks(self) -> int:
        return self.other_idx.shape[1]

    @property
    def chunk_len(self) -> int:
        return self.other_idx.shape[2]

    @property
    def block_entities(self) -> int:
        return self.entity_ids.shape[1]


def _auto_block_chunks(total_chunks: int, chunk_len: int, rank_hint: int = 64,
                       target_bytes: int = 192 * 2**20) -> int:
    """Pick C_B so a block's gathered [C_B, L, k] tensor stays ~target_bytes."""
    per_chunk = chunk_len * rank_hint * 4
    cb = max(64, min(total_chunks, target_bytes // max(per_chunk, 1)))
    # round up to a multiple of 8 for tidy tiling
    return int(-(-cb // 8) * 8)


def _auto_block_entities(block_chunks: int, n_active: int,
                         total_chunks: int) -> int:
    """U_B sized so real entities nearly fill the solve batch: average
    entities-per-chunk times C_B with ~35% headroom, multiple of 8."""
    ratio = n_active / max(total_chunks, 1)
    ub = int(np.ceil(block_chunks * ratio * 1.35))
    ub = max(8, min(block_chunks, ub))
    return int(-(-ub // 8) * 8)


def build_blocked_csr(
    entity_idx: np.ndarray,
    other_idx: np.ndarray,
    rating: np.ndarray,
    n_entities: int,
    n_other: int,
    chunk_len: int = 32,
    block_chunks: Optional[int] = None,
    rank_hint: int = 64,
    block_entities: Optional[int] = None,
) -> BlockedCSR:
    """Build the blocked layout grouping by ``entity_idx``.

    For the ALS U-step, entity=user and other=item; the V-step uses the same
    builder with the roles swapped (the reference's "transposed per-item view",
    SURVEY.md call stack 3.2).
    """
    entity_idx = np.asarray(entity_idx, dtype=np.int64)
    other_idx = np.asarray(other_idx, dtype=np.int64)
    rating = np.asarray(rating, dtype=np.float32)
    nnz = entity_idx.shape[0]
    if not (other_idx.shape[0] == rating.shape[0] == nnz):
        raise ValueError("COO arrays must share length")
    if nnz and (entity_idx.max() >= n_entities or other_idx.max() >= n_other
                or entity_idx.min() < 0 or other_idx.min() < 0):
        # negatives must be loud: jnp's clamping gather would silently remap
        # a -1 sentinel to row 0 and pollute that entity's Gram/RHS
        raise ValueError("index out of range")
    L = int(chunk_len)

    # group by (entity, other): ascending item order within each entity
    # improves DRAM locality of the device gather at zero build cost
    order = entity_order(entity_idx, other_idx, n_other)
    e_sorted = entity_idx[order]
    o_sorted = other_idx[order]
    r_sorted = rating[order]

    counts = np.bincount(e_sorted, minlength=n_entities).astype(np.int64)
    active = np.nonzero(counts)[0]  # entities with >=1 rating
    n_chunks_per = -(-counts[active] // L)  # ceil
    total_chunks = int(n_chunks_per.sum())

    C_B = block_chunks or _auto_block_chunks(total_chunks, L, rank_hint)
    C_B = int(max(C_B, int(n_chunks_per.max(initial=1))))  # a mega-entity must fit
    U_B = block_entities or _auto_block_entities(C_B, active.shape[0],
                                                 total_chunks)
    U_B = int(min(U_B, C_B))  # an entity owns >=1 chunk, so U_B > C_B is waste

    # greedy pack entities into blocks; close a block when either budget fills
    blocks: list[list[int]] = [[]]  # active-entity positions per block
    used = 0
    for pos in range(active.shape[0]):
        need = int(n_chunks_per[pos])
        if (used + need > C_B or len(blocks[-1]) >= U_B) and blocks[-1]:
            blocks.append([])
            used = 0
        blocks[-1].append(pos)
        used += need
    if not blocks[-1] and len(blocks) > 1:
        blocks.pop()
    NB = len(blocks)

    out_oi = np.full((NB, C_B, L), n_other, dtype=np.int32)
    out_r = np.zeros((NB, C_B, L), dtype=np.float32)
    out_seg = np.full((NB, C_B), U_B, dtype=np.int32)
    out_eid = np.full((NB, U_B), n_entities, dtype=np.int32)
    out_cnt = np.zeros((NB, U_B), dtype=np.float32)

    # packing plan per active entity: (block, slot, first chunk row)
    n_active = active.shape[0]
    block_of = np.empty(n_active, np.int32)
    slot_of = np.empty(n_active, np.int32)
    chunk_base = np.empty(n_active, np.int32)
    a = 0
    for b, members in enumerate(blocks):
        c = 0
        for slot, pos in enumerate(members):
            block_of[a] = b
            slot_of[a] = slot
            chunk_base[a] = c
            c += int(n_chunks_per[pos])
            a += 1
    assert a == n_active

    out_eid[block_of, slot_of] = active.astype(np.int32)
    out_cnt[block_of, slot_of] = counts[active]

    # starts of each active entity in the sorted COO
    ent_starts = np.zeros(n_entities + 1, dtype=np.int64)
    np.cumsum(counts, out=ent_starts[1:])
    starts = np.empty(n_active + 1, np.int64)
    starts[:-1] = ent_starts[active]
    starts[-1] = ent_starts[active[-1] + 1] if n_active else 0

    # One vectorized fill (the JAX package fills entity by entity, in C++
    # or NumPy; the arrays are the same): rating q of active entity a goes
    # to flat slot chunk_base[a] * L + (q - starts[a]) of block block_of[a],
    # and each of a's chunks to chunk_seg slot slot_of[a].
    a_of = np.repeat(np.arange(n_active), counts[active])
    pos = (chunk_base[a_of].astype(np.int64) * L
           + np.arange(starts[-1], dtype=np.int64) - starts[a_of])
    blk = block_of[a_of]
    out_oi.reshape(NB, -1)[blk, pos] = o_sorted
    out_r.reshape(NB, -1)[blk, pos] = r_sorted
    a_ch = np.repeat(np.arange(n_active), n_chunks_per)
    first = np.cumsum(n_chunks_per) - n_chunks_per
    out_seg[block_of[a_ch], chunk_base[a_ch]
            + np.arange(total_chunks) - first[a_ch]] = slot_of[a_ch]

    return BlockedCSR(out_oi, out_r, out_seg, out_eid, out_cnt)


def layout_stats(layout: BlockedCSR, nnz: int) -> dict:
    """Padding-efficiency stats (SURVEY.md §7 hard part: padding waste)."""
    slots = layout.other_idx.size
    return {
        "n_blocks": layout.n_blocks,
        "block_chunks": layout.block_chunks,
        "chunk_len": layout.chunk_len,
        "padded_slots": slots,
        "nnz": nnz,
        "fill": nnz / slots if slots else 0.0,
    }


def pad_coo(user_idx, item_idx, rating, n_users: int, n_items: int,
            multiple: int = 1024):
    """Pad a COO triple to a multiple, pointing padding at the trash rows.

    The zero-row/zero-bias convention zeroes the FACTOR/BIAS contribution of
    padded entries, but predictions still include mu — padded entries
    predict mu, not 0, whenever mu != 0 (SGD states). Consumers MUST mask
    by index (< n_users) rather than trust padding to contribute zero error;
    rmse_padded (models/base.py) does exactly that. Used by the RMSE path
    (SURVEY.md call stack 3.4).
    """
    user_idx = np.asarray(user_idx, dtype=np.int32)
    item_idx = np.asarray(item_idx, dtype=np.int32)
    rating = np.asarray(rating, dtype=np.float32)
    n = user_idx.shape[0]
    m = int(-(-max(n, 1) // multiple) * multiple)
    pu = np.full(m, n_users, dtype=np.int32)
    pi = np.full(m, n_items, dtype=np.int32)
    pr = np.zeros(m, dtype=np.float32)
    pu[:n], pi[:n], pr[:n] = user_idx, item_idx, rating
    return pu, pi, pr, n

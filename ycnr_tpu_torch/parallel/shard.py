"""Sharded training on ``torch.distributed`` (counterpart of
``ycnr_tpu/parallel/shard.py``).

The reference's worker parallelism, one rank per process:

* P1 (user phase): users are partitioned across the ranks, balanced by
  rating count (LPT); each rank solves its users' normal equations against
  a replicated V.
* P2 (item phase): ratings stay sharded by user; each rank accumulates
  partial per-item Grams and right-hand sides from its ratings, the mesh
  all-reduces them (``Mesh.all_reduce_``), and every rank runs one batched
  solve over all items (BASELINE.json config 5: "allreduces item Gram
  matrices").
* P3 (SGD, BPR): each rank runs its users' rating stream; U / b_u updates
  stay local, the V / b_i deltas are all-reduced once a batch.

State layout on a rank: ``U`` / ``bu`` hold the rank's users with *local*
indexing (``[upd + 1, k]``; row ``upd`` is the trash row), ``V`` / ``bi``
/ ``mu`` are replicated. ``scatter_state`` / ``gather_state`` convert
to / from the single-GPU ``MFState``; ``gather_state`` is a collective.

The host builders (``_lpt_partition`` .. ``build_sharded_data``,
``build_bpr_bits``) are copies of the JAX package's and return every
shard's arrays stacked on a leading ``[D, ...]`` axis as NumPy, equal to
the JAX builders' output under ``np.asarray``. A rank then puts only its
own slice on its device (``put_shard``).

What a kernel computes runs through the port's kernels: the user phase is
``ops/gram.solve_block`` (``row_gather``, chunk einsums, the segment sum,
K1), the item phase gathers the local U through ``row_gather`` and solves
through K1, the SGD / BPR row reads go through ``row_gather`` and serving
through K2 (``ops/fused_topn``) where ``eval/recommend.use_fused`` says.

Random draws cannot match ``jax.random``: a rank's SGD permutation and
BPR negatives come from ``torch.Generator(device).manual_seed(
rank_seed(seed, epoch, rank))``; each epoch function also takes them
explicitly (``perm`` / ``negs`` / ``order``) so that parity runs can pass
the JAX package's own draws.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ycnr_tpu_torch.models.base import MFState, scatter_add_
from ycnr_tpu_torch.ops.gram import (
    BlockData,
    chunk_gram_rhs,
    guarded_batched_solve,
    segment_reduce_block,
    solve_block,
)
from ycnr_tpu_torch.ops.layout import (
    BlockedCSR,
    _auto_block_chunks,
    _auto_block_entities,
    build_blocked_csr,
)
from ycnr_tpu_torch.ops.row_gather import row_gather
from ycnr_tpu_torch.parallel.mesh import Mesh


class ShardedState(NamedTuple):
    """One rank's state: its users' rows (local indexing) and the
    replicated item side."""

    U: torch.Tensor  # [upd + 1, k] local user rows, row upd = trash
    V: torch.Tensor  # [n_items + 1, k] replicated
    bu: torch.Tensor  # [upd + 1]
    bi: torch.Tensor  # [n_items + 1] replicated
    mu: torch.Tensor  # 0-d, replicated


class ShardedData(NamedTuple):
    """The sharded inputs. From ``build_sharded_data``: NumPy, every
    shard's arrays stacked on a leading ``[D]`` axis (``item_deg`` is not
    sharded). From ``put_shard``: one rank's slice as tensors on its
    device (no leading axis)."""

    user_layout: BlockedCSR  # [D, NB_u, ...]; entity = LOCAL user
    item_layout: BlockedCSR  # [D, NB_i, ...]; entity = GLOBAL item,
    #                           other = LOCAL user
    item_deg: object  # [n_items + 1] global item degree (float)
    sgd_u: object  # [D, n_sgd] LOCAL user idx (pad -> upd)
    sgd_i: object  # [D, n_sgd] GLOBAL item idx (pad -> n_items)
    sgd_r: object  # [D, n_sgd]
    test_u: object  # [D, n_test] LOCAL user idx (pad -> upd)
    test_i: object  # [D, n_test] GLOBAL item idx
    test_r: object  # [D, n_test]


@dataclass
class ShardedMeta:
    """Host-side bookkeeping."""

    n_users: int
    n_items: int
    n_shards: int
    upd: int  # users per rank (padded)
    user_map: np.ndarray  # [D, upd] global user id per local row (pad n_users)
    user_local: np.ndarray  # [n_users] (shard, local) packed: shard*upd+local
    test_n: int  # real held-out count
    sgd_n: int  # real train count in the sgd stream
    user_layout_host: "BlockedCSR | None" = None  # NumPy [D, NB, ...] user
    #   layout for host-side builders (build_rated_bits for serving)


def np_dtype(dtype):
    """The NumPy dtype of a torch (or NumPy) floating dtype."""
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def rank_seed(seed: int, epoch: int, rank: int) -> int:
    """The seed of rank ``rank``'s draws in ``epoch`` (the counterpart of
    ``jax.random.fold_in(fold_in(key(seed), epoch), rank)``)."""
    return int(seed) + 7919 * int(epoch) + 104_729 * int(rank)


# ---------------------------------------------------------------------------
# Host builders (copies of the JAX package's, NumPy out)
# ---------------------------------------------------------------------------

def _lpt_partition(degrees: np.ndarray, D: int):
    """Longest-processing-time entity partition balanced by rating count.

    Zero-degree entities carry no load, so plain LPT would pile them all on
    one argmin shard — inflating the padded per-shard entity count (upd) and
    every [D, upd+1, k] buffer by up to the inactive-entity count; they are
    dealt to the smallest member lists instead, balancing counts. Heap-based
    (O(n log D)).
    """
    order = np.argsort(-degrees, kind="stable")
    n_active = int((degrees > 0).sum())
    shard_of = np.zeros(len(degrees), np.int32)
    members: list[list[int]] = [[] for _ in range(D)]
    heap = [(0, d) for d in range(D)]  # (load, shard); ties -> lowest shard
    for u in order[:n_active]:
        load, d = heapq.heappop(heap)
        shard_of[u] = d
        members[d].append(int(u))
        heapq.heappush(heap, (load + int(degrees[u]), d))
    if n_active < len(order):
        by_count = sorted(range(D), key=lambda d: len(members[d]))
        for j, u in enumerate(order[n_active:]):
            d = by_count[j % D]
            shard_of[u] = d
            members[d].append(int(u))
    return members, shard_of


def _pad_blocks(layout: BlockedCSR, nb: int, n_entities: int,
                n_other: int) -> BlockedCSR:
    """Pad a layout to nb blocks with fully-empty blocks."""
    add = nb - layout.n_blocks
    if add == 0:
        return layout
    C_B, L = layout.other_idx.shape[1:]
    U_B = layout.entity_ids.shape[1]
    return BlockedCSR(
        np.concatenate([layout.other_idx,
                        np.full((add, C_B, L), n_other, np.int32)]),
        np.concatenate([layout.rating, np.zeros((add, C_B, L), np.float32)]),
        np.concatenate([layout.chunk_seg, np.full((add, C_B), U_B, np.int32)]),
        np.concatenate([layout.entity_ids,
                        np.full((add, U_B), n_entities, np.int32)]),
        np.concatenate([layout.entity_cnt, np.zeros((add, U_B), np.float32)]),
    )


def _stack_layouts(lays: list) -> BlockedCSR:
    """Stack per-shard layouts into one [D, ...]-leading BlockedCSR."""
    return BlockedCSR(*(np.stack([getattr(l, f) for l in lays])
                        for f in BlockedCSR._fields))


def _stacked(lay: BlockedCSR, dtype) -> BlockedCSR:
    """Stacked layout with ratings and counts in ``dtype`` (the JAX
    package's ``_device_stacked``, on the host)."""
    dt = np_dtype(dtype)
    return BlockedCSR(np.asarray(lay.other_idx), lay.rating.astype(dt),
                      np.asarray(lay.chunk_seg), np.asarray(lay.entity_ids),
                      lay.entity_cnt.astype(dt))


def _stack_ragged(per_shard: list, pads: tuple, round_to: int = 8):
    """Pad a per-shard tuple of equal-length 1-D arrays into [D, n] blocks
    (n = max shard length rounded up to `round_to`; float pads -> float32
    output, int pads -> int32). Shared by the test-COO and SGD-stream
    builders of both sharded modes."""
    D = len(per_shard)
    n = max(1, max(len(t[0]) for t in per_shard))
    n = int(-(-n // round_to) * round_to)
    outs = []
    for c, pad in enumerate(pads):
        dt = np.float32 if isinstance(pad, float) else np.int32
        a = np.full((D, n), pad, dt)
        for d, t in enumerate(per_shard):
            a[d, : len(t[c])] = t[c]
        outs.append(a)
    return outs


def build_sharded_data(
    train_u, train_i, train_r, n_users: int, n_items: int, n_shards: int,
    chunk_len: int = 32, block_chunks=None, rank_hint: int = 64,
    test_u=None, test_i=None, test_r=None, sgd_batch: int = 4096,
    dtype=np.float32, host_user_layout: bool = False, algo: str = "all",
):
    """Partition ratings by user across shards and build every shard's
    inputs on the host. Returns (ShardedData of stacked NumPy arrays,
    ShardedMeta); ``put_shard`` moves one rank's slice to its device.

    host_user_layout=True keeps the per-shard user layout on
    ``meta.user_layout_host`` for host-side builders (serving bits).
    ``algo`` ("als"/"ials"/"sgd"/"bpr"/"all") gates the expensive inputs:
    the alternating solvers never read the SGD/BPR stream and SGD/BPR never
    read the blocked layouts. Unused fields become empty placeholders of
    the same structure.
    """
    need_user_layout = algo in ("all", "als", "ials") or host_user_layout
    need_item_layout = algo in ("all", "als", "ials")
    need_sgd = algo in ("all", "sgd", "bpr")
    D = n_shards
    train_u = np.asarray(train_u)
    train_i = np.asarray(train_i)
    train_r = np.asarray(train_r, np.float32)
    deg_u = np.bincount(train_u, minlength=n_users)
    members, shard_of = _lpt_partition(deg_u, D)
    upd = max(len(m) for m in members)

    user_map = np.full((D, upd), n_users, np.int32)
    user_local = np.zeros(n_users, np.int64)
    for d, m in enumerate(members):
        user_map[d, : len(m)] = m
        for j, u in enumerate(m):
            user_local[u] = d * upd + j
    local_of = user_local % upd  # [n_users] local row

    # --- per-shard COO ---
    shard_idx = shard_of[train_u]
    per = [np.nonzero(shard_idx == d)[0] for d in range(D)]

    # choose one C_B valid for every shard's user- and item-major layouts
    max_user_chunks = int(np.max(-(-deg_u // chunk_len), initial=1))
    deg_i_per = [np.bincount(train_i[p], minlength=n_items) for p in per]
    max_item_chunks = max(int(np.max(-(-di // chunk_len), initial=1))
                          for di in deg_i_per)
    if block_chunks is None:
        total = int(-(-len(train_r) // (chunk_len * max(D, 1))))
        block_chunks = _auto_block_chunks(max(total, 1), chunk_len, rank_hint)
    C_B = max(block_chunks, max_user_chunks, max_item_chunks)

    # uniform entity budgets across shards (stacked arrays must agree)
    ub_user, ub_item = 8, 8
    for d, p in enumerate(per):
        du = np.bincount(train_u[p], minlength=1)
        du = du[du > 0]
        chunks_u = int(np.sum(-(-du // chunk_len))) or 1
        ub_user = max(ub_user, _auto_block_entities(C_B, len(du), chunks_u))
        di = deg_i_per[d][deg_i_per[d] > 0]
        chunks_i = int(np.sum(-(-di // chunk_len))) or 1
        ub_item = max(ub_item, _auto_block_entities(C_B, len(di), chunks_i))

    u_lays, i_lays = [], []
    for d, pfull in enumerate(per):
        pu = pfull if need_user_layout else pfull[:0]
        pi = pfull if need_item_layout else pfull[:0]
        u_lays.append(build_blocked_csr(
            local_of[train_u[pu]].astype(np.int64), train_i[pu], train_r[pu],
            upd, n_items, chunk_len, C_B, block_entities=ub_user))
        i_lays.append(build_blocked_csr(
            train_i[pi], local_of[train_u[pi]].astype(np.int64), train_r[pi],
            n_items, upd, chunk_len, C_B, block_entities=ub_item))
    nb_u = max(l.n_blocks for l in u_lays)
    nb_i = max(l.n_blocks for l in i_lays)
    u_lays = [_pad_blocks(l, nb_u, upd, n_items) for l in u_lays]
    i_lays = [_pad_blocks(l, nb_i, n_items, upd) for l in i_lays]
    user_layout = _stack_layouts(u_lays)
    item_layout = _stack_layouts(i_lays)

    item_deg = np.zeros(n_items + 1, np.float32)
    item_deg[:n_items] = np.bincount(train_i, minlength=n_items)

    # --- SGD stream: each shard's ratings, padded to a common length that is
    # a whole number of local batches ---
    b_local = max(1, sgd_batch // D)
    sgd_per = per if need_sgd else [p[:0] for p in per]
    if algo == "bpr":
        # one fixed per-shard row shuffle so the "batches" shuffle mode's
        # FIXED batch composition is a random partition of each shard's
        # stream, not the file order; the "rows" mode re-permutes per
        # epoch anyway, so this is inert there
        rng = np.random.default_rng(0)
        sgd_per = [rng.permutation(p) for p in sgd_per]
    sgd_u, sgd_i, sgd_r = _stack_ragged(
        [(local_of[train_u[p]], train_i[p], train_r[p]) for p in sgd_per],
        pads=(upd, n_items, 0.0), round_to=b_local)

    # --- held-out COO sharded by the same user partition ---
    if test_u is None:
        test_u = np.zeros(0, np.int32)
        test_i = np.zeros(0, np.int32)
        test_r = np.zeros(0, np.float32)
    test_u = np.asarray(test_u)
    test_i = np.asarray(test_i)
    test_r = np.asarray(test_r, np.float32)
    tper = [np.nonzero(shard_of[test_u] == d)[0] for d in range(D)]
    tu, ti, tr = _stack_ragged(
        [(local_of[test_u[p]], test_i[p], test_r[p]) for p in tper],
        pads=(upd, n_items, 0.0))

    dt = np_dtype(dtype)
    data = ShardedData(
        user_layout=_stacked(user_layout, dt),
        item_layout=_stacked(item_layout, dt),
        item_deg=item_deg.astype(dt),
        sgd_u=sgd_u, sgd_i=sgd_i, sgd_r=sgd_r.astype(dt),
        test_u=tu, test_i=ti, test_r=tr.astype(dt),
    )
    meta = ShardedMeta(n_users=n_users, n_items=n_items, n_shards=D, upd=upd,
                       user_map=user_map, user_local=user_local,
                       test_n=len(test_r), sgd_n=len(train_r),
                       user_layout_host=(user_layout if host_user_layout
                                         else None))
    return data, meta


class BPRShardAux(NamedTuple):
    """Per-shard BPR side tables: stacked [D, ...] NumPy from
    ``build_bpr_bits``, one rank's tensors from ``put_shard``."""

    bits: object  # [D, upd+1, W] uint32 local-user rated bits
    wu: object    # [D, upd+1] f32 per-shard "emean" user weights
    wi: object    # [D, n_items+1] f32 per-shard "emean" item weights


def build_bpr_bits(train_u, train_i, meta: ShardedMeta,
                   batch_size: int) -> BPRShardAux:
    """Per-shard BPR tables: the packed rated-bits collision slabs (one
    per shard, local user rows; trailing trash row zero) plus the
    expected-multiplicity weight vectors for grad_mode="emean", computed
    per shard from ITS stream (local degrees, local batch size — the same
    per-rank semantics the sharded "mean" mode has)."""
    from ycnr_tpu_torch.models.bpr import expected_weights, pack_rated_bits

    D, upd = meta.n_shards, meta.upd
    if batch_size <= 0:  # b_local=1 would silently turn emean into sum
        raise ValueError("build_bpr_bits needs the training batch_size "
                         "(the emean weights are per-batch expectations)")
    b_local = max(1, int(batch_size) // D)
    W = (int(meta.n_items) + 31) // 32
    bits = np.zeros((D, upd + 1, W), np.uint32)
    wu = np.zeros((D, upd + 1), np.float32)
    wi = np.zeros((D, int(meta.n_items) + 1), np.float32)
    u = np.asarray(train_u)
    i = np.asarray(train_i)
    shard = meta.user_local[u] // upd
    local = meta.user_local[u] % upd
    for d in range(D):
        m = shard == d
        bits[d] = pack_rated_bits(local[m], i[m], upd, meta.n_items)
        wu[d], wi[d] = expected_weights(local[m], i[m], b_local, upd,
                                        meta.n_items)
    return BPRShardAux(bits, wu, wi)


# ---------------------------------------------------------------------------
# Device side: this rank's slice
# ---------------------------------------------------------------------------

def _tensor(x, device):
    x = np.asarray(x)
    if x.dtype == np.uint32:  # torch has few uint32 ops; same bits
        x = x.view(np.int32)
    return torch.as_tensor(np.ascontiguousarray(x), device=device)


def put_shard(data, mesh: Mesh):
    """This rank's slice of a stacked ``ShardedData`` / ``BPRShardAux``
    (or any NamedTuple of [D, ...] arrays) as tensors on ``mesh.device``;
    ``item_deg`` is replicated. The counterpart of ``put_sharded``."""
    d = mesh.rank

    def one(name, x):
        if isinstance(x, BlockedCSR):
            return BlockedCSR(*(_tensor(np.asarray(f)[d], mesh.device)
                                for f in x))
        if name == "item_deg":
            return _tensor(x, mesh.device)
        return _tensor(np.asarray(x)[d], mesh.device)

    return type(data)(*(one(n, x) for n, x in zip(data._fields, data)))


def scatter_state(state: MFState, meta: ShardedMeta,
                  mesh: Mesh) -> ShardedState:
    """Global MFState -> this rank's ShardedState on ``mesh.device``."""
    dev = mesh.device
    upd = meta.upd
    rows = torch.as_tensor(meta.user_map[mesh.rank], dtype=torch.long,
                           device=state.U.device)
    k = state.U.shape[1]
    U = state.U.new_zeros(upd + 1, k)
    bu = state.bu.new_zeros(upd + 1)
    # user_map pad entries point at n_users == the global trash row (zeros)
    U[:upd] = state.U[rows]
    bu[:upd] = state.bu[rows]
    return ShardedState(U.to(dev), state.V.to(dev, copy=True), bu.to(dev),
                        state.bi.to(dev, copy=True), state.mu.to(dev))


def gather_state(st: ShardedState, meta: ShardedMeta,
                 mesh: Mesh) -> MFState:
    """This rank's view -> the global MFState on ``mesh.device``. A
    collective (an all-gather of U and b_u): every rank calls it at the
    same point, or the run deadlocks."""
    k = st.U.shape[1]
    Ub = torch.cat([st.U, st.bu[:, None]], dim=1)
    Ush = torch.stack(mesh.all_gather(Ub))  # [D, upd+1, k+1]
    dev = st.U.device
    valid = torch.as_tensor(meta.user_map < meta.n_users, device=dev)
    umap = torch.as_tensor(meta.user_map, dtype=torch.long, device=dev)
    out = Ush.new_zeros(meta.n_users + 1, k + 1)
    out[umap[valid]] = Ush[:, :-1][valid]
    return MFState(out[:, :k].contiguous(), st.V.clone(),
                   out[:, k].contiguous(), st.bi.clone(), st.mu.clone())


# ---------------------------------------------------------------------------
# ALS-WR / iALS epochs
# ---------------------------------------------------------------------------

def _blocks(layout: BlockedCSR):
    return (BlockData(*blk) for blk in zip(*layout))


def _solve_phase_local(E: torch.Tensor, F: torch.Tensor,
                       layout: BlockedCSR, lam: float, alpha=None,
                       base_gram=None, gather_bf16: bool = False):
    """Re-solve this rank's entity rows of E (in place) against F: the
    user phase, one ``solve_block`` per block."""
    for blk in _blocks(layout):
        eid, rows = solve_block(F, blk, lam, gram_weight_alpha=alpha,
                                base_gram=base_gram,
                                base_reg=lam if alpha is not None else 0.0,
                                gather_bf16=gather_bf16)
        E[eid] = rows.to(E.dtype)
    return E


def _gram_psum_phase_local(mesh: Mesh, F_local: torch.Tensor,
                           layout: BlockedCSR, entity_deg, *, lam: float,
                           n_entities: int, alpha=None, base_gram=None,
                           gather_bf16: bool = False):
    """Accumulate partial per-entity Grams / right-hand sides from this
    rank's ratings, all-reduce them, then one batched solve over every
    entity, the same on every rank (the item phase)."""
    k = F_local.shape[-1]
    dt = F_local.dtype
    A = F_local.new_zeros(n_entities + 1, k, k)
    b = F_local.new_zeros(n_entities + 1, k)
    F_src = F_local.to(torch.bfloat16) if gather_bf16 else F_local
    for blk in _blocks(layout):
        Fg = row_gather(F_src, blk.other_idx)  # [C_B, L, k]
        if alpha is None:
            G, bb = chunk_gram_rhs(Fg, blk.rating, acc_dtype=dt)
        else:
            w = alpha * blk.rating
            G, bb = chunk_gram_rhs(Fg, blk.rating, weight=w,
                                   rhs_weight=1.0 + w, acc_dtype=dt)
        As, bs = segment_reduce_block(G, bb, blk.chunk_seg,
                                      blk.entity_ids.shape[0])
        eid = blk.entity_ids.long()
        # padding slots all land on the trash entity n_entities (zeros)
        scatter_add_(A, eid, As)
        scatter_add_(b, eid, bs)
    return psum_solve(mesh, A, b, entity_deg, lam, alpha, base_gram)


def psum_solve(mesh: Mesh, A: torch.Tensor, b: torch.Tensor, entity_deg,
               lam: float, alpha=None, base_gram=None) -> torch.Tensor:
    """All-reduce this rank's partial normal equations ``A`` / ``b`` (in
    place), then the ridge (ALS-WR: ``lam * deg + (deg == 0)``; iALS: the
    base Gram and ``lam``) and one batched solve over every entity, the
    same on every rank."""
    mesh.all_reduce_(A)  # the item Gram all-reduce [BASELINE.json:5]
    mesh.all_reduce_(b)
    if alpha is None:
        reg = lam * entity_deg + (entity_deg == 0)
    else:
        A = A + base_gram[None]
        reg = torch.full_like(entity_deg, lam)
    return guarded_batched_solve(A, b, reg.to(A.dtype))


def sharded_als_epoch(mesh: Mesh, st: ShardedState, data: ShardedData,
                      lam: float, gather_bf16: bool = False) -> ShardedState:
    """One ALS-WR epoch: the local user phase, then the item phase with
    the item Gram all-reduce. U is updated in place."""
    n_items = st.V.shape[0] - 1
    U = _solve_phase_local(st.U, st.V, data.user_layout, float(lam),
                           gather_bf16=gather_bf16)
    V = _gram_psum_phase_local(mesh, U, data.item_layout, data.item_deg,
                               lam=float(lam), n_entities=n_items,
                               gather_bf16=gather_bf16)
    return st._replace(U=U, V=V.to(st.V.dtype))


def sharded_ials_epoch(mesh: Mesh, st: ShardedState, data: ShardedData,
                       lam: float, alpha: float,
                       gather_bf16: bool = False) -> ShardedState:
    """One iALS epoch: V^T V is replicated (a local product), U^T U a
    local product and an all-reduce."""
    n_items = st.V.shape[0] - 1
    GV = st.V.T @ st.V
    U = _solve_phase_local(st.U, st.V, data.user_layout, float(lam),
                           alpha=float(alpha), base_gram=GV,
                           gather_bf16=gather_bf16)
    GU = mesh.all_reduce_(U.T @ U)
    V = _gram_psum_phase_local(mesh, U, data.item_layout, data.item_deg,
                               lam=float(lam), n_entities=n_items,
                               alpha=float(alpha), base_gram=GU,
                               gather_bf16=gather_bf16)
    return st._replace(U=U, V=V.to(st.V.dtype))


# ---------------------------------------------------------------------------
# SGD and BPR epochs (per-batch V / b_i all-reduce)
# ---------------------------------------------------------------------------

def _index(x, device) -> torch.Tensor:
    """Draws given as a tensor or as NumPy (copied: a read-only array
    cannot back a tensor) -> int64 on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device).long()
    return torch.from_numpy(np.array(x, dtype=np.int64)).to(device)


def _generator(seed: int, epoch: int, rank: int, device):
    return torch.Generator(device).manual_seed(rank_seed(seed, epoch, rank))


def sharded_sgd_epoch(mesh: Mesh, st: ShardedState, data: ShardedData,
                      lam: float, lr, batch_size: int, perm=None,
                      seed: int = 0, epoch: int = 0) -> ShardedState:
    """One data-parallel biased-SGD epoch (sum semantics): this rank's
    stream in the order ``perm`` (drawn from ``rank_seed(seed, epoch,
    rank)`` when None), local U / b_u updates, and the V / b_i deltas of
    every batch all-reduced before the next. Every rank has the same
    number of batches (``_stack_ragged`` pads each shard to whole local
    batches), so the all-reduces pair up."""
    b_local = max(1, int(batch_size) // mesh.world)
    dev = st.U.device
    n = data.sgd_u.shape[0]
    if perm is None:
        perm = torch.randperm(n, generator=_generator(seed, epoch, mesh.rank,
                                                      dev), device=dev)
    perm = _index(perm, dev)
    ub_all = data.sgd_u[perm].long().view(-1, b_local)
    ib_all = data.sgd_i[perm].long().view(-1, b_local)
    rb_all = data.sgd_r[perm].view(-1, b_local)
    U, V, bu, bi = st.U, st.V, st.bu, st.bi
    upd, k = U.shape[0] - 1, U.shape[1]
    lr, lam = float(lr), float(lam)
    mu = st.mu
    dVb = torch.empty(V.shape[0], k + 1, dtype=V.dtype, device=dev)
    for ub, ib, rb in zip(ub_all, ib_all, rb_all):
        Uu = row_gather(U, ub)
        Vi = row_gather(V, ib)
        buu = bu[ub]
        bii = bi[ib]
        pred = mu + buu + bii + (Uu * Vi).sum(1)
        m = (ub < upd).to(U.dtype)
        e = (rb - pred) * m
        scatter_add_(U, ub, lr * m[:, None] * (e[:, None] * Vi - lam * Uu))
        scatter_add_(bu, ub, lr * m * (e - lam * buu))
        # V / b_i deltas cross user shards: one all-reduce a batch (P3)
        dVb.zero_()
        scatter_add_(dVb, ib, torch.cat(
            [lr * m[:, None] * (e[:, None] * Uu - lam * Vi),
             (lr * m * (e - lam * bii))[:, None]], dim=1))
        mesh.all_reduce_(dVb)
        V += dVb[:, :k]
        bi += dVb[:, k]
    return st


def sharded_bpr_epoch(mesh: Mesh, st: ShardedState, data: ShardedData,
                      aux: BPRShardAux, lam: float, lr, batch_size: int,
                      grad_mode: str = "mean", shuffle: str = "rows",
                      perm=None, negs=None, seed: int = 0,
                      epoch: int = 0) -> ShardedState:
    """One data-parallel BPR epoch (``models/bpr.py`` on the mesh):
    positives ride this rank's stream, negatives are drawn per rank, U
    updates stay local and the fused V / b_i deltas are all-reduced once a
    batch. ``perm`` is the row permutation ("rows") or the batch order
    ("batches"), ``negs`` the rank's [n_sgd] negatives; both are drawn
    from ``rank_seed(seed, epoch, rank)`` when None. Semantics as the
    reference's: each rank shuffles and batches ITS OWN stream, and
    grad_mode="mean" multiplicities are per rank."""
    from ycnr_tpu_torch.models.bpr import (bpr_batch_deltas, check_shuffle,
                                           fuse_bpr_state)

    check_shuffle(shuffle)
    b_local = max(1, int(batch_size) // mesh.world)
    dev = st.U.device
    n = data.sgd_u.shape[0]
    upd, k = st.U.shape[0] - 1, st.U.shape[1]
    n_items = st.V.shape[0] - 1
    if (perm is None) != (negs is None):
        raise ValueError("pass perm AND negs together (parity runs) or "
                         "neither (fresh per-epoch draws)")
    if perm is None:
        gen = _generator(seed, epoch, mesh.rank, dev)
        negs = torch.randint(0, n_items, (n,), generator=gen, device=dev)
        perm = torch.randperm(n // b_local if shuffle == "batches" else n,
                              generator=gen, device=dev)
    perm = _index(perm, dev)
    jb_all = _index(negs, dev).view(-1, b_local)
    if shuffle == "batches":
        u2 = data.sgd_u.long().view(-1, b_local)
        i2 = data.sgd_i.long().view(-1, b_local)
        batches = ((u2[b], i2[b]) for b in perm.tolist())
    else:
        batches = zip(data.sgd_u[perm].long().view(-1, b_local),
                      data.sgd_i[perm].long().view(-1, b_local))
    Uf, Vf = fuse_bpr_state(st.U, st.V, st.bi, aux.wu, aux.wi, grad_mode)
    dVf = torch.empty_like(Vf)
    lr, lam = float(lr), float(lam)
    for (ubt, ibt), jbt in zip(batches, jb_all):
        du, dvi, dvj = bpr_batch_deltas(Uf, Vf, aux.bits, ubt, ibt, jbt,
                                        upd, lam, lr, grad_mode)
        scatter_add_(Uf, ubt, du)  # local users: no collective
        dVf.zero_()
        scatter_add_(dVf, torch.cat([ibt, jbt]), torch.cat([dvi, dvj]))
        # V / b_i rows cross user shards: all-reduce the deltas (P3); the
        # weight column's deltas are zero
        Vf += mesh.all_reduce_(dVf)
    return st._replace(U=Uf[:, :k].contiguous(), V=Vf[:, :k].contiguous(),
                       bi=Vf[:, k].to(st.bi.dtype).contiguous())


# ---------------------------------------------------------------------------
# Serving and evaluation
# ---------------------------------------------------------------------------

def _gather_lists(mesh: Mesh, ids, sc, entity_ids, user_map, upd,
                  n: int):
    """All ranks' [NB, U_B, n] lists -> (users, items, scores) in global
    user ids, shard by shard in rank order, as NumPy on every rank (a
    collective)."""
    ids_all = [x.cpu().numpy() for x in mesh.all_gather(ids)]
    sc_all = [x.cpu().numpy() for x in mesh.all_gather(sc)]
    eids_all = [x.cpu().numpy() for x in mesh.all_gather(entity_ids)]
    out_u, out_i, out_s = [], [], []
    for d in range(mesh.world):
        slots = eids_all[d].reshape(-1)
        real = slots < upd
        out_u.append(user_map[d][slots[real]])
        out_i.append(ids_all[d].reshape(-1, n)[real])
        out_s.append(sc_all[d].reshape(-1, n)[real])
    return (np.concatenate(out_u), np.concatenate(out_i),
            np.concatenate(out_s))


def topn_local(st: ShardedState, entity_ids, n: int, bits=None,
               method: str = "exact", n_items: Optional[int] = None,
               layout: Optional[BlockedCSR] = None):
    """[NB, U_B, n] top items and scores for this rank's users against
    the replicated V: K2 (``fused_topn_core``) when ``method`` is fused
    and ``use_fused`` allows, else the exact scorer (``topn_block``; with
    ``bits`` its mask path, without them the scatter path over
    ``layout``)."""
    from ycnr_tpu_torch.eval.recommend import _pad_items, topn_block, \
        use_fused
    from ycnr_tpu_torch.ops.fused_topn import fused_topn_core

    n_items = st.V.shape[0] - 1 if n_items is None else n_items
    if method != "exact" and bits is None:
        # K2 reads the rated bits; the reference scores exact without them
        if st.U.device.type != "cpu":
            raise ValueError(f"method {method!r} needs rated_bits")
        method = "exact"
    if bits is not None and use_fused(method, n_items, n, st.U.device):
        return fused_topn_core(st.U, st.V, st.bu, st.bi, st.mu, entity_ids,
                               bits, n, score_bf16=(method != "fused32"))
    ids, sc = [], []
    if bits is not None:
        V, bi = _pad_items(st.V, st.bi, bits.shape[-1])
        for eids, b in zip(entity_ids, bits):
            i, s = topn_block(st.U, V, st.bu, bi, st.mu, eids.long(), n,
                              rated_bits=b)
            ids.append(i)
            sc.append(s)
    else:
        for eids, seg, oi in zip(entity_ids, layout.chunk_seg,
                                 layout.other_idx):
            i, s = topn_block(st.U, st.V, st.bu, st.bi, st.mu, eids.long(),
                              n, chunk_seg=seg.long(), other_idx=oi.long())
            ids.append(i)
            sc.append(s)
    return torch.stack(ids), torch.stack(sc)


def sharded_recommend_all(mesh: Mesh, st: ShardedState, data: ShardedData,
                          meta: ShardedMeta, n: int = 10, rated_bits=None,
                          method: str = "exact"):
    """Top-N for every rated user: each rank scores its own users against
    the replicated V and masks with its local layout, then the lists are
    gathered (a collective). Returns (user_ids, item_ids [m, n], scores
    [m, n]) as NumPy in GLOBAL user ids, on every rank.

    rated_bits [D, NB, U_B, W] (``build_rated_bits`` of the stacked host
    user layout, ``meta.user_layout_host``) selects the bits path; None
    keeps the scatter path. ``method`` "fused" / "fused32" run K2 on
    every rank; a catalog too small for it is served "exact" on the CPU
    and raises on the card (``eval/recommend.use_fused``: the reference
    turns it into "exact" everywhere)."""
    from ycnr_tpu_torch.eval.recommend import bits_tensor

    bits = (None if rated_bits is None
            else bits_tensor(np.asarray(rated_bits)[mesh.rank], st.U.device))
    ids, sc = topn_local(st, data.user_layout.entity_ids, n, bits, method,
                         layout=data.user_layout)
    return _gather_lists(mesh, ids, sc, data.user_layout.entity_ids,
                         meta.user_map, meta.upd, n)


def sharded_rmse(mesh: Mesh, st: ShardedState, data: ShardedData,
                 test_n: int) -> float:
    """Held-out RMSE: a local sum of squares, all-reduced."""
    tu, ti = data.test_u.long(), data.test_i.long()
    upd = st.U.shape[0] - 1
    pred = st.mu + st.bu[tu] + st.bi[ti] + (st.U[tu] * st.V[ti]).sum(1)
    e = torch.where(tu < upd, data.test_r - pred, 0.0)
    sq = mesh.all_reduce_((e * e).sum().reshape(1))
    return float(torch.sqrt(sq[0] / max(int(test_n), 1)))

"""Dual-sharded ALS / iALS: users AND items sharded, the other side
all-gathered (counterpart of ``ycnr_tpu/parallel/dual.py``, the
``item_sharded`` V-step).

Instead of keeping ratings user-sharded and all-reducing per-item Gram
matrices ([n_items, k, k]: 0.44 GB at ML-20M rank 64), the item axis is
sharded too and each shard's ratings are re-bucketed by item. An epoch then
moves two factor all-gathers (U: ~35 MB, V: ~7 MB at ML-20M rank 64), and
the item solves are sharded instead of replicated.

Index convention ("cat space"): with D shards and per-shard padded sizes
upd / ipd, global user u living at (shard d, local j) is addressed as
d * (upd + 1) + j in the all-gathered ``U_cat`` = cat(all_gather(U_local))
of shape [D * (upd + 1), k]. Every shard's row ``upd`` is an all-zero trash
row, so layout padding points at cat index D * (upd + 1) - 1 (the last
shard's trash row) and the zero-row trick holds unchanged.

The host builder and ``dual_rated_bits`` are the JAX package's, copied,
NumPy out; a rank puts only its slice on its device. SGD keeps the
V-replicated scheme of ``parallel/shard.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ycnr_tpu_torch.models.base import MFState
from ycnr_tpu_torch.ops.layout import (
    BlockedCSR,
    _auto_block_chunks,
    _auto_block_entities,
    build_blocked_csr,
)
from ycnr_tpu_torch.parallel.mesh import Mesh
from ycnr_tpu_torch.parallel.shard import (
    ShardedState,
    _gather_lists,
    _lpt_partition,
    _pad_blocks,
    _solve_phase_local,
    _stack_layouts,
    _stack_ragged,
    _stacked,
    np_dtype,
    topn_local,
)


class DualState(NamedTuple):
    """One rank's rows of both factors."""

    U: torch.Tensor  # [upd + 1, k] local user rows
    V: torch.Tensor  # [ipd + 1, k] local item rows
    mu: torch.Tensor  # 0-d (ALS/iALS keep no biases)


class DualData(NamedTuple):
    """Stacked [D, ...] NumPy (``build_dual_sharded_data``) or one rank's
    tensors (``put_shard``)."""

    user_layout: BlockedCSR  # entity = local user, other = V cat index
    item_layout: BlockedCSR  # entity = local item, other = U cat index
    test_u: object  # [D, n_test] local user idx (pad -> upd)
    test_i: object  # [D, n_test] V cat idx (pad -> ipd)
    test_r: object  # [D, n_test]


@dataclass
class DualMeta:
    n_users: int
    n_items: int
    n_shards: int
    upd: int
    ipd: int
    user_map: np.ndarray  # [D, upd] global user per slot (pad n_users)
    item_map: np.ndarray  # [D, ipd] global item per slot (pad n_items)
    user_cat: np.ndarray  # [n_users] cat index of each user
    item_cat: np.ndarray  # [n_items] cat index of each item
    test_n: int
    user_layout_host: "BlockedCSR | None" = None  # NumPy copy for serving
    #   mask builders (dual_rated_bits); kept only when requested


def _partition(idx_count: np.ndarray, D: int):
    members, shard_of = _lpt_partition(idx_count, D)
    pd = max(len(m) for m in members)
    emap = np.full((D, pd), len(idx_count), np.int32)
    cat = np.zeros(len(idx_count), np.int64)
    for d, m in enumerate(members):
        emap[d, : len(m)] = m
        for j, e in enumerate(m):
            cat[e] = d * (pd + 1) + j
    return members, shard_of, pd, emap, cat


def build_dual_sharded_data(
    train_u, train_i, train_r, n_users: int, n_items: int, n_shards: int,
    chunk_len: int = 32, block_chunks=None, rank_hint: int = 64,
    test_u=None, test_i=None, test_r=None, dtype=np.float32,
    host_user_layout: bool = False,
):
    """Partition users and items, re-bucket each shard's ratings both
    ways; returns (DualData of stacked NumPy arrays, DualMeta)."""
    D = n_shards
    train_u = np.asarray(train_u)
    train_i = np.asarray(train_i)
    train_r = np.asarray(train_r, np.float32)
    deg_u = np.bincount(train_u, minlength=n_users)
    deg_i = np.bincount(train_i, minlength=n_items)
    _, ushard, upd, user_map, user_cat = _partition(deg_u, D)
    _, ishard, ipd, item_map, item_cat = _partition(deg_i, D)

    uper = [np.nonzero(ushard[train_u] == d)[0] for d in range(D)]
    iper = [np.nonzero(ishard[train_i] == d)[0] for d in range(D)]

    max_user_chunks = int(np.max(-(-deg_u // chunk_len), initial=1))
    max_item_chunks = int(np.max(-(-deg_i // chunk_len), initial=1))
    if block_chunks is None:
        total = int(-(-len(train_r) // (chunk_len * max(D, 1))))
        block_chunks = _auto_block_chunks(max(total, 1), chunk_len, rank_hint)
    C_B = max(block_chunks, max_user_chunks, max_item_chunks)

    ub_u = max(_auto_block_entities(
        C_B, max(1, int(np.count_nonzero(np.bincount(train_u[p], minlength=1)))),
        max(1, int(-(-len(p) // chunk_len)))) for p in uper)
    ub_i = max(_auto_block_entities(
        C_B, max(1, int(np.count_nonzero(np.bincount(train_i[p], minlength=1)))),
        max(1, int(-(-len(p) // chunk_len)))) for p in iper)

    u_local = user_cat % (upd + 1)
    i_local = item_cat % (ipd + 1)
    u_lays, i_lays = [], []
    for d in range(D):
        p = uper[d]
        u_lays.append(build_blocked_csr(
            u_local[train_u[p]], item_cat[train_i[p]], train_r[p],
            upd, D * (ipd + 1) - 1, chunk_len, C_B, block_entities=ub_u))
        q = iper[d]
        i_lays.append(build_blocked_csr(
            i_local[train_i[q]], user_cat[train_u[q]], train_r[q],
            ipd, D * (upd + 1) - 1, chunk_len, C_B, block_entities=ub_i))
    nb_u = max(l.n_blocks for l in u_lays)
    nb_i = max(l.n_blocks for l in i_lays)
    u_lays = [_pad_blocks(l, nb_u, upd, D * (ipd + 1) - 1) for l in u_lays]
    i_lays = [_pad_blocks(l, nb_i, ipd, D * (upd + 1) - 1) for l in i_lays]
    user_layout, item_layout = _stack_layouts(u_lays), _stack_layouts(i_lays)

    if test_u is None:
        test_u = np.zeros(0, np.int32)
        test_i = np.zeros(0, np.int32)
        test_r = np.zeros(0, np.float32)
    test_u = np.asarray(test_u)
    test_i = np.asarray(test_i)
    test_r = np.asarray(test_r, np.float32)
    tper = [np.nonzero(ushard[test_u] == d)[0] for d in range(D)]
    # test item padding -> ipd = shard-0's trash row in cat space
    tu, ti, tr = _stack_ragged(
        [(u_local[test_u[p]], item_cat[test_i[p]], test_r[p]) for p in tper],
        pads=(upd, ipd, 0.0))

    dt = np_dtype(dtype)
    data = DualData(user_layout=_stacked(user_layout, dt),
                    item_layout=_stacked(item_layout, dt),
                    test_u=tu, test_i=ti, test_r=tr.astype(dt))
    meta = DualMeta(n_users=n_users, n_items=n_items, n_shards=D, upd=upd,
                    ipd=ipd, user_map=user_map, item_map=item_map,
                    user_cat=user_cat, item_cat=item_cat, test_n=len(test_r),
                    user_layout_host=user_layout if host_user_layout
                    else None)
    return data, meta


def dual_scatter_state(state: MFState, meta: DualMeta,
                       mesh: Mesh) -> DualState:
    """Global MFState -> this rank's rows of U and V on its device."""
    dev = mesh.device
    k = state.U.shape[1]

    def local(F, emap, pd):
        rows = torch.as_tensor(emap[mesh.rank], dtype=torch.long,
                               device=F.device)
        out = F.new_zeros(pd + 1, k)
        out[:pd] = F[rows]  # pad entries point at the global trash row
        return out.to(dev)

    return DualState(local(state.U, meta.user_map, meta.upd),
                     local(state.V, meta.item_map, meta.ipd),
                     state.mu.to(dev))


def dual_gather_state(st: DualState, meta: DualMeta,
                      mesh: Mesh) -> MFState:
    """All ranks' rows -> the global MFState on this rank's device. A
    collective (all-gathers of U and V): every rank calls it."""
    dev = st.U.device

    def glob(F, emap, n):
        Fsh = torch.stack(mesh.all_gather(F))
        valid = torch.as_tensor(emap < n, device=dev)
        idx = torch.as_tensor(emap, dtype=torch.long, device=dev)
        out = F.new_zeros(n + 1, F.shape[1])
        out[idx[valid]] = Fsh[:, :-1][valid]
        return out

    U = glob(st.U, meta.user_map, meta.n_users)
    V = glob(st.V, meta.item_map, meta.n_items)
    return MFState(U, V, U.new_zeros(meta.n_users + 1),
                   U.new_zeros(meta.n_items + 1), st.mu.clone())


def _cat(mesh: Mesh, F: torch.Tensor) -> torch.Tensor:
    return torch.cat(mesh.all_gather(F))


def _dual_epoch(mesh: Mesh, st: DualState, data: DualData, lam: float,
                alpha=None, gather_bf16: bool = False) -> DualState:
    lam = float(lam)
    V_cat = _cat(mesh, st.V)
    GV = None if alpha is None else mesh.all_reduce_(st.V.T @ st.V)
    Ul = _solve_phase_local(st.U, V_cat, data.user_layout, lam, alpha, GV,
                            gather_bf16=gather_bf16)
    U_cat = _cat(mesh, Ul)
    GU = None if alpha is None else mesh.all_reduce_(Ul.T @ Ul)
    Vl = _solve_phase_local(st.V, U_cat, data.item_layout, lam, alpha, GU,
                            gather_bf16=gather_bf16)
    return DualState(Ul, Vl, st.mu)


def dual_als_epoch(mesh: Mesh, st: DualState, data: DualData, lam: float,
                   gather_bf16: bool = False) -> DualState:
    """One ALS-WR epoch: gather V, solve the local users; gather U, solve
    the local items. Rows are written in place."""
    return _dual_epoch(mesh, st, data, lam, None, gather_bf16)


def dual_ials_epoch(mesh: Mesh, st: DualState, data: DualData, lam: float,
                    alpha: float, gather_bf16: bool = False) -> DualState:
    """One iALS epoch; the global Grams are local products all-reduced."""
    return _dual_epoch(mesh, st, data, lam, float(alpha), gather_bf16)


def dual_rmse(mesh: Mesh, st: DualState, data: DualData,
              test_n: int) -> float:
    """Held-out RMSE against the gathered V: a local sum of squares,
    all-reduced."""
    V_cat = _cat(mesh, st.V)
    tu, ti = data.test_u.long(), data.test_i.long()
    upd = st.U.shape[0] - 1
    pred = st.mu + (st.U[tu] * V_cat[ti]).sum(1)
    e = torch.where(tu < upd, data.test_r - pred, 0.0)
    sq = mesh.all_reduce_((e * e).sum().reshape(1))
    return float(torch.sqrt(sq[0] / max(int(test_n), 1)))


def dual_rated_bits(meta: DualMeta) -> np.ndarray:
    """Packed serving mask in item-CAT space [D, NB, U_B, W].

    Beyond each user's rated items, every cat slot that is not a real item
    (per-shard padding slots and trash rows — their V rows are zero, so
    they'd score mu and outrank negatively-scored real items) is masked.
    Needs build_dual_sharded_data(host_user_layout=True).
    """
    from ycnr_tpu_torch.eval.recommend import build_rated_bits

    if meta.user_layout_host is None:
        raise ValueError("build data with host_user_layout=True for serving")
    n_cat = meta.n_shards * (meta.ipd + 1)
    bits = build_rated_bits(meta.user_layout_host, n_cat - 1)
    valid = np.zeros(bits.shape[-1] * 32, bool)
    for d in range(meta.n_shards):
        base = d * (meta.ipd + 1)
        valid[base : base + meta.ipd] = meta.item_map[d] < meta.n_items
    shifts = (np.uint32(1) << np.arange(32, dtype=np.uint32))[None, :]
    inv_words = np.bitwise_or.reduce(
        np.where(~valid.reshape(-1, 32), shifts, np.uint32(0)), axis=1)
    return bits | inv_words  # broadcast over [D, NB, U_B, W]


def dual_topn_local(mesh: Mesh, st: DualState, data: DualData, n: int,
                    bits: torch.Tensor, method: str, n_cat: int):
    """[NB, U_B, n] top cat-space items for this rank's users: one V
    all-gather, then K2 where ``method`` is fused and ``use_fused``
    allows for the bitmask's width ``n_cat``, else the exact scorer."""
    V_cat = _cat(mesh, st.V)
    view = ShardedState(st.U, V_cat, st.U.new_zeros(st.U.shape[0]),
                        V_cat.new_zeros(V_cat.shape[0]), st.mu)
    return topn_local(view, data.user_layout.entity_ids, n, bits, method,
                      n_items=n_cat)


def dual_recommend_all(mesh: Mesh, st: DualState, data: DualData,
                       meta: DualMeta, n: int = 10, rated_bits=None,
                       method: str = "exact"):
    """Top-N for every rated user with V sharded (``dual_topn_local``),
    masked with the cat-space rated bits (``dual_rated_bits``, built here
    when None), the lists gathered (a collective). Returns (user_ids,
    item_ids [m, n], scores [m, n]) as NumPy in GLOBAL ids, on every
    rank."""
    from ycnr_tpu_torch.eval.recommend import bits_tensor

    if rated_bits is None:
        rated_bits = dual_rated_bits(meta)
    rated_bits = np.asarray(rated_bits)
    bits = bits_tensor(rated_bits[mesh.rank], st.U.device)
    ids, sc = dual_topn_local(mesh, st, data, n, bits, method,
                              rated_bits.shape[-1] * 32 - 1)
    users, ids, sc = _gather_lists(mesh, ids, sc,
                                   data.user_layout.entity_ids,
                                   meta.user_map, meta.upd, n)
    # cat -> global item lookup (padded score columns -> n_items)
    lut = np.full(rated_bits.shape[-1] * 32, meta.n_items, np.int64)
    for d in range(meta.n_shards):
        base = d * (meta.ipd + 1)
        lut[base : base + meta.ipd] = meta.item_map[d]
    return users, lut[ids], sc

"""Sharded out-of-core ALS-WR / iALS on ``torch.distributed`` (counterpart
of ``ycnr_tpu/parallel/ooc_mesh.py``).

The rating wire of ``ops/packed.py`` split over the ranks, one process a
rank (``parallel/mesh.py``):

* user phase: the GLOBAL user-view wire is built once and sliced into
  contiguous per-rank block runs, group by group (blocks hold disjoint
  consecutive entities, so any block partition is a user partition, and
  equal slices of a group balance to within one block). Each rank decodes
  its blocks, solves them against the replicated V and writes each
  block's rows in place into its local ``U [upd + 1, k]``;
* item phase: each rank's ratings form its own ITEM-view wire (entity =
  global item, other = LOCAL user row). A rank decodes it, adds each
  block's partial normal equations into ``A [n_items + 1, k, k]`` / ``b``,
  and the mesh all-reduces them before one batched solve over every item
  on every rank (``parallel/shard.psum_solve``, the resident item phase's
  tail).

The decode, the chunk walk and the block step are ``models/ooc.py``'s, so
a block runs the single-GPU out-of-core kernels: bf16 ALS-WR on CUDA
through the fused gather -> Gram kernel (with the ridge in the user
phase, without it in the item phase) and K1, every other case through the
row-gather kernel, the einsums and K1. The factors are a
``parallel/shard.ShardedState``, so ``scatter_state`` / ``gather_state``
/ ``sharded_rmse``, checkpoints and serving work unchanged.

Two tiers, as the reference's: ``put_sharded_wire`` pins this rank's
slice on its device (``epoch(st)``); ``feed_sharded_wire`` hands it as
host arrays that ``models/ooc.ChunkStream`` streams through its pinned
staging ring every epoch (``epoch(st, rank_wire)``), so only the chunks
in flight occupy device memory. Both touch only this rank's rows of the
stacked host wire, and both run the same blocks in the same order: the
same bits.

The host builder is a copy of the JAX package's and returns NumPy, every
rank's arrays stacked on a leading ``[D, ...]`` axis. Not ported, because
they exist for the TPU: the wire-ordered solve table ``Ep`` and its
assemble-by-gather (a block's rows are written in place through the
inverse of ``inv_local``), ``lax.pcast``, the ``NamedSharding``
placement and the donated wire buffers (a rank holds its own slice).
Unlike the single-GPU phase, the bf16 gather copy has no size cap,
as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ycnr_tpu_torch.models.base import scatter_add_
from ycnr_tpu_torch.models.bucketed_phase import fused_base, uses_fused
from ycnr_tpu_torch.models.ooc import (block_rows, decoded_blocks,
                                       gather_normal_eq, wire_tensor)
from ycnr_tpu_torch.ops.fused_gram import fused_gram
from ycnr_tpu_torch.ops.packed import PackedGroup, build_packed
from ycnr_tpu_torch.parallel.mesh import Mesh
from ycnr_tpu_torch.parallel.shard import (ShardedData, ShardedMeta,
                                           _stack_ragged, _tensor,
                                           psum_solve)

_WIRE = ("lo", "hi_pos", "hi_val", "rat", "cnt", "eid")
_PREFETCH = 2  # streamed chunks in flight, as models/ooc.py's default


class ShardedWire(NamedTuple):
    """The sharded wire of one ALS/iALS epoch.

    From ``build_sharded_wire``: ``ugroups`` / ``igroups`` are tuples of
    PackedGroup whose array leaves carry a leading [D] rank axis ([D, NB,
    ...]); u-view eid is the GLOBAL user id (pad n_users; padding blocks
    2**31 - 2), i-view eid the GLOBAL item id (pad n_items), i-view deltas
    encode LOCAL user rows (pad upd). ``u_off``: per u-group [NB] local
    wire-order slot offsets (identical across ranks by construction).
    ``inv_local`` [D, upd+1] maps local user row -> wire-order slot
    (u_rows: cold users and the trash row). ``item_deg`` [n_items+1]
    global item degrees (the solve's regularizer). From
    ``put_sharded_wire`` / ``feed_sharded_wire``: one rank's slice (no
    leading axis)."""

    ugroups: Tuple[PackedGroup, ...]
    igroups: Tuple[PackedGroup, ...]
    u_off: Tuple[np.ndarray, ...]
    inv_local: object
    item_deg: object
    u_rows: int      # local wire-order slots
    u_scratch: int   # the reference's scratch rows for chunk-pad writes


def _slice_group(g: PackedGroup, D: int) -> PackedGroup:
    """[NB, ...] wire group -> [D, NBD, ...] contiguous block slices,
    padded with empty blocks (cnt 0, eid 2**31 - 2 — decode to nothing)."""
    nb = g.n_blocks
    nbd = -(-nb // D)
    out = {}
    for name in _WIRE:
        a = np.asarray(getattr(g, name))
        pad_shape = (nbd * D - nb,) + a.shape[1:]
        if name == "eid":
            pad = np.full(pad_shape, np.int32(2**31 - 2), a.dtype)
        else:
            pad = np.zeros(pad_shape, a.dtype)
        out[name] = np.concatenate([a, pad]).reshape((D, nbd) + a.shape[1:])
    return g._replace(**out)


def _pad_to(a: np.ndarray, shape, fill=0) -> np.ndarray:
    out = np.full(shape, fill, a.dtype)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


def build_sharded_wire(tu, ti, tr, n_users: int, n_items: int, D: int,
                       rank_hint: int = 64, max_groups: int = 8,
                       target_bytes: int = 48 * 2**20):
    """Partition ratings by user across D ranks, in wire format. Returns
    (ShardedWire of stacked NumPy arrays, ShardedMeta).

    The user-view wire is built ONCE globally and sliced per rank (same
    groups on every rank); the item views are built per rank from the
    rank's ratings with LOCAL user rows and shape-padded to a common [D,
    ...] stack (a group's R becomes the max over ranks — padding slots
    decode to nothing, exactly like in-block padding)."""
    tu = np.asarray(tu)
    ti = np.asarray(ti)
    tr = np.asarray(tr, np.float32)

    # ---- user view: global wire, contiguous block slices per rank ----
    ug = build_packed(tu, ti, tr, n_users, n_items, rank_hint=rank_hint,
                      target_bytes=target_bytes, max_groups=max_groups)
    ugroups = tuple(_slice_group(g, D) for g in ug)

    # per-rank membership + local offsets (identical across ranks)
    u_off, base = [], 0
    scratch = 1
    user_map_lists = [[] for _ in range(D)]
    inv_pos = [[] for _ in range(D)]
    for g, gs in zip(ug, ugroups):
        nbd, NE = gs.cnt.shape[1], gs.cnt.shape[2]
        u_off.append(base + np.arange(nbd, dtype=np.int32) * NE)
        scratch = max(scratch, NE)
        eid = np.asarray(gs.eid)  # [D, nbd, NE]
        for d in range(D):
            e = eid[d].ravel()
            m = e < n_users
            user_map_lists[d].append(e[m])
            inv_pos[d].append(base + np.nonzero(m)[0].astype(np.int64))
        base += nbd * NE
    u_rows = base

    # cold (zero-rating) users appear in no wire block; deal them to the
    # smallest member lists so they still own a local row (kept at the 0
    # zero_cold_entities gives it), as the resident partition does
    seen = np.zeros(n_users, bool)
    for lst in user_map_lists:
        for x in lst:
            seen[x] = True
    cold = np.nonzero(~seen)[0]
    counts = [sum(len(x) for x in lst) for lst in user_map_lists]
    by_count = sorted(range(D), key=lambda d: counts[d])
    for j, cu in enumerate(cold):
        user_map_lists[by_count[j % D]].append(np.asarray([cu], np.int32))
    counts = [sum(len(x) for x in lst) for lst in user_map_lists]
    upd = int(-(-max(max(counts), 1) // 8) * 8)
    user_map = np.full((D, upd), n_users, np.int32)
    user_local = np.full(n_users, 0, np.int64)
    inv_local = np.full((D, upd + 1), u_rows, np.int32)
    for d in range(D):
        ids = (np.concatenate(user_map_lists[d]) if user_map_lists[d]
               else np.zeros(0, np.int32))
        pos = (np.concatenate(inv_pos[d]) if inv_pos[d]
               else np.zeros(0, np.int64))
        user_map[d, : len(ids)] = ids
        user_local[ids] = d * upd + np.arange(len(ids))
        inv_local[d, : len(pos)] = pos  # wire members lead; cold follow

    # ---- item view: per-rank local wires, shape-padded + stacked ----
    shard_of = np.full(n_users, -1, np.int32)
    for d in range(D):
        m = user_map[d] < n_users
        shard_of[user_map[d][m]] = d
    loc_row = (user_local % upd).astype(np.int32)
    per_shard = []
    n_groups_i = 0
    for d in range(D):
        m = shard_of[tu] == d
        gi = build_packed(ti[m], loc_row[tu[m]], tr[m], n_items, upd,
                          rank_hint=rank_hint, target_bytes=target_bytes,
                          max_groups=max_groups)
        per_shard.append(gi)
        n_groups_i = max(n_groups_i, len(gi))

    # a rating SUBSET can qualify for the int8 half-star wire while the
    # full set (or another rank's) does not — stacking int8 next to f32
    # would silently promote the CODES (2x the rating). Force one kind.
    kinds = {g.rating_kind for s in per_shard for g in s}
    if len(kinds) > 1:
        def as_raw(g):
            if g.rating_kind != "half":
                return g
            return g._replace(rat=np.asarray(g.rat, np.float32) * 0.5,
                              rating_kind="raw")

        per_shard = [tuple(as_raw(g) for g in s) for s in per_shard]

    igroups = []
    for gidx in range(n_groups_i):
        gs = [s[gidx] if gidx < len(s) else None for s in per_shard]
        live = [g for g in gs if g is not None]
        R = max(g.R for g in live)
        kind = live[0].rating_kind
        dims = {}
        for name in _WIRE:
            dims[name] = tuple(
                max((np.asarray(getattr(g, name)).shape[i] for g in live))
                for i in range(np.asarray(getattr(live[0], name)).ndim))
        stacked = {}
        for name in _WIRE:
            fill = n_items if name == "eid" else 0
            dt = np.asarray(getattr(live[0], name)).dtype
            stacked[name] = np.stack([
                np.full(dims[name], fill, dt) if g is None
                else _pad_to(np.asarray(getattr(g, name)), dims[name], fill)
                for g in gs])
        igroups.append(PackedGroup(R=R, n_other=upd, rating_kind=kind,
                                   **stacked))

    item_deg = np.bincount(ti, minlength=n_items).astype(np.float32)
    item_deg = np.concatenate([item_deg, np.zeros(1, np.float32)])

    sw = ShardedWire(ugroups=ugroups, igroups=tuple(igroups),
                     u_off=tuple(u_off), inv_local=inv_local,
                     item_deg=item_deg, u_rows=int(u_rows),
                     u_scratch=int(scratch))
    meta = ShardedMeta(n_users=n_users, n_items=n_items, n_shards=D,
                       upd=upd, user_map=user_map, user_local=user_local,
                       test_n=0, sgd_n=0)
    return sw, meta


def _rank_wire(sw: ShardedWire, mesh: Mesh, leaf) -> ShardedWire:
    """Slice ``[mesh.rank]`` of every wire leaf through ``leaf``;
    ``inv_local[rank]`` and ``item_deg`` as tensors on the rank's device.
    No other rank's rows are read."""
    d, dev = mesh.rank, mesh.device

    def groups(gs):
        return tuple(g._replace(**{n: leaf(np.asarray(getattr(g, n))[d])
                                   for n in _WIRE}) for g in gs)

    return sw._replace(
        ugroups=groups(sw.ugroups), igroups=groups(sw.igroups),
        inv_local=torch.from_numpy(np.array(np.asarray(sw.inv_local)[d],
                                            np.int64)).to(dev),
        item_deg=torch.from_numpy(np.array(sw.item_deg)).to(dev))


def put_sharded_wire(sw: ShardedWire, mesh: Mesh) -> ShardedWire:
    """The pinned tier: this rank's slice of a stacked host wire, every
    leaf a tensor on ``mesh.device`` (the sharded counterpart of
    ``models/ooc.wire_to_device``). The slice is copied first: a wire
    memory-mapped from ``spawn_ranks``' ``.npy`` set is read-only, which a
    tensor may not wrap."""
    return _rank_wire(sw, mesh,
                      lambda a: wire_tensor(np.array(a), mesh.device))


def feed_sharded_wire(sw: ShardedWire, mesh: Mesh) -> ShardedWire:
    """The streamed tier: this rank's slice of a stacked host wire as host
    arrays (views of NumPy arrays or memmaps, nothing copied here), which
    ``models/ooc.ChunkStream`` stages through its pinned ring to the device
    chunk by chunk every epoch. Pair with ``make_sharded_ooc_epoch(...,
    wire_as_args=True)``."""
    return _rank_wire(sw, mesh, lambda a: a)


def put_test_rows(meta: ShardedMeta, test_u, test_i, test_r, mesh: Mesh,
                  dtype) -> ShardedData:
    """This rank's held-out rows (local user rows) as the ``ShardedData``
    that ``shard.sharded_rmse`` reads; sets ``meta.test_n``. Cold users own
    rows that stay 0, so their predictions are 0, as on one device."""
    test_u, test_i = np.asarray(test_u), np.asarray(test_i)
    test_r = np.asarray(test_r)
    shard_of = meta.user_local // meta.upd
    local_of = meta.user_local % meta.upd
    per = [np.nonzero(shard_of[test_u] == d)[0]
           for d in range(meta.n_shards)]
    tu, ti, tr = _stack_ragged(
        [(local_of[test_u[p]], test_i[p], test_r[p]) for p in per],
        pads=(meta.upd, meta.n_items, 0.0))
    meta.test_n = len(test_r)
    d, dev = mesh.rank, mesh.device
    return ShardedData(None, None, None, None, None, None,
                       _tensor(tu[d], dev), _tensor(ti[d], dev),
                       _tensor(tr[d], dev).to(dtype))


def split_wire(sw: ShardedWire):
    """(skeleton, arrays): ``sw`` with each array leaf replaced by a name,
    and the arrays by name, for ``spawn_ranks``' ``.npy`` set."""
    arrays = {}

    def named(key, a):
        arrays[key] = a
        return key

    def groups(gs, tag):
        return tuple(g._replace(**{n: named(f"wire_{tag}{j}_{n}",
                                            getattr(g, n)) for n in _WIRE})
                     for j, g in enumerate(gs))

    skel = sw._replace(ugroups=groups(sw.ugroups, "u"),
                       igroups=groups(sw.igroups, "i"),
                       inv_local=named("wire_inv_local", sw.inv_local),
                       item_deg=named("wire_item_deg", sw.item_deg))
    return skel, arrays


def join_wire(skel: ShardedWire, arrays: dict) -> ShardedWire:
    """``split_wire``'s inverse over the arrays by name (memory-mapped in
    a rank process)."""
    def groups(gs):
        return tuple(g._replace(**{n: arrays[getattr(g, n)] for n in _WIRE})
                     for g in gs)

    return skel._replace(ugroups=groups(skel.ugroups),
                         igroups=groups(skel.igroups),
                         inv_local=arrays[skel.inv_local],
                         item_deg=arrays[skel.item_deg])


def _local_rows(wire: ShardedWire) -> list:
    """Per user-view group, [NB, NE] int64: the local U row each block
    slot of this rank writes, ``upd`` (the trash row) where the slot holds
    no user (in-block padding, ``_slice_group``'s padding blocks). The
    inverse of ``inv_local`` (local row -> wire-order slot) over the
    blocks' slot offsets ``u_off``."""
    inv = wire.inv_local
    dev, upd = inv.device, inv.shape[0] - 1
    slot_row = torch.full((wire.u_rows + 1,), upd, dtype=torch.long,
                          device=dev)
    live = inv < wire.u_rows
    slot_row[inv[live]] = torch.arange(upd + 1, device=dev)[live]
    return [slot_row[torch.as_tensor(off, dtype=torch.long, device=dev)[
        :, None] + torch.arange(g.cnt.shape[1], device=dev)]
        for off, g in zip(wire.u_off, wire.ugroups)]


def _user_phase(U, V, wire, rows_of, lam, alpha, base_gram,
                gather_bf16: bool, chunk_blocks):
    """Re-solve this rank's users (in place) against the replicated V from
    its user-view blocks. Padding slots solve to exactly 0 into the trash
    row; cold users keep their rows."""
    F_g = V.to(torch.bfloat16) if gather_bf16 else V
    fused = uses_fused(U.device, U.dtype, alpha, gather_bf16, U.shape[1])
    rdt = torch.bfloat16 if fused else U.dtype
    if fused:
        base_gram = fused_base(base_gram)
    for gi, b, oi, rr, cntf, _ in decoded_blocks(
            wire.ugroups, U.device, rdt, U.dtype, _PREFETCH, chunk_blocks):
        U[rows_of[gi][b]] = block_rows(F_g, oi, rr, cntf, lam, alpha,
                                       base_gram, U.dtype, gather_bf16,
                                       fused)
    return U


def _item_phase(mesh, U, wire, n_items: int, lam, alpha, base_gram,
                gather_bf16: bool, chunk_blocks):
    """Partial per-item normal equations from this rank's item-view
    blocks, then the all-reduce and one solve over every item. An item
    sits in one block of a rank's wire; padding entities add zeros to the
    trash row ``n_items``. The fused branch's partials are weighted for
    iALS but take no base Gram and no ridge: ``psum_solve`` adds those
    after the all-reduce."""
    k, dt = U.shape[1], U.dtype
    F_g = U.to(torch.bfloat16) if gather_bf16 else U
    fused = uses_fused(U.device, dt, alpha, gather_bf16, k)
    rdt = torch.bfloat16 if fused else dt
    A = U.new_zeros(n_items + 1, k, k)
    b = U.new_zeros(n_items + 1, k)
    for _, _, oi, rr, _, eid in decoded_blocks(
            wire.igroups, U.device, rdt, dt, _PREFETCH, chunk_blocks):
        dA, db = (fused_gram(F_g, oi, rr, alpha=alpha) if fused else
                  gather_normal_eq(F_g, oi, rr, alpha, dt, gather_bf16))
        scatter_add_(A, eid, dA)
        scatter_add_(b, eid, db)
    return psum_solve(mesh, A, b, wire.item_deg.to(dt), lam, alpha,
                      base_gram)


def make_sharded_ooc_epoch(mesh: Mesh, sw: Optional[ShardedWire],
                           lam: float, alpha: Optional[float] = None,
                           gather_bf16: bool = False,
                           wire_as_args: bool = False,
                           chunk_blocks: Optional[int] = None):
    """One ALS-WR (``alpha`` None) or iALS sharded out-of-core epoch.

    Returns ``epoch(st) -> st`` over the pinned rank wire ``sw``
    (``put_sharded_wire``), or with ``wire_as_args`` ``epoch(st,
    rank_wire) -> st`` over the rank wire given each call (``sw`` unused;
    ``feed_sharded_wire`` streams it). ``chunk_blocks``: blocks per
    streamed chunk (default ~48 MB of wire). U is updated in place; V is
    a new tensor, the same on every rank. iALS takes ``V^T V`` on every
    rank and ``U^T U`` as the all-reduce of the local products. The
    factors' dtype is the state's (the reference's ``dtype`` argument)."""
    lam = float(lam)
    alpha = None if alpha is None else float(alpha)

    def run(st, wire, rows_of):
        n_items = st.V.shape[0] - 1
        GV = st.V.T @ st.V if alpha is not None else None
        U = _user_phase(st.U, st.V, wire, rows_of, lam, alpha, GV,
                        gather_bf16, chunk_blocks)
        GU = mesh.all_reduce_(U.T @ U) if alpha is not None else None
        V = _item_phase(mesh, U, wire, n_items, lam, alpha, GU, gather_bf16,
                        chunk_blocks)
        return st._replace(U=U, V=V.to(st.V.dtype))

    if wire_as_args:
        return lambda st, wire: run(st, wire, _local_rows(wire))
    rows_of = _local_rows(sw)
    return lambda st: run(st, sw, rows_of)

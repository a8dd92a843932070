"""Data-parallel stream SGD on the mesh (counterpart of
``ycnr_tpu/parallel/sgd_stream.py``).

Each rank holds its users' ratings as a user-sorted, per-batch item-sorted
stream (``models/sgd_stream.prepare_stream_sgd`` per shard, a common tile,
the batch count padded to the largest shard's). In every global step each
rank runs one local batch (U-tile gather and scatter-add, both through
the port's ordered kernels) and the dense ``[n_items + 1, k + 1]`` V / b_i
delta is all-reduced: the per-batch collective of the shuffled path at
the stream's cost.

One global batch is the union of the D local batches, updated at
batch-start parameters. In "sum" mode this is the single-GPU stream epoch
on the concatenated stream; in "mean" mode multiplicities are per LOCAL
batch, as in the reference.

The host builder is the JAX package's, copied; it returns stacked NumPy
arrays and ``put_shard`` gives a rank its slice. The batch order is the
same on every rank: ``order``, or ``torch.randperm`` from
``torch.Generator(device).manual_seed(seed + 7919 * epoch)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ycnr_tpu_torch.models.base import scatter_add_
from ycnr_tpu_torch.models.sgd_stream import _bias_col, _host_order
from ycnr_tpu_torch.ops.row_gather import row_gather
from ycnr_tpu_torch.parallel.mesh import Mesh
from ycnr_tpu_torch.parallel.shard import ShardedMeta, ShardedState, np_dtype


class ShardedStreamSGD(NamedTuple):
    """Per-shard streams stacked on a leading [D] axis (NumPy), or one
    rank's slice as tensors (``put_shard``). ``tile`` and ``grad_mode``
    are plain values; ``u_lo`` stays a host array."""

    ul: object  # [D, NB, B] int32 LOCAL user row within the tile
    ib: object  # [D, NB, B] int32 global item id, sorted per batch
    rb: object  # [D, NB, B]
    wu: object  # [D, NB, B] per-row user-side weight (pad -> 0)
    wi: object  # [D, NB, B] per-row item-side weight
    u_lo: object  # [D, NB] int32 tile starts (local row space)
    tile: int
    grad_mode: str


def build_sharded_stream_sgd(train_u, train_i, train_r, meta: ShardedMeta,
                             batch_size: int, seed: int = 0,
                             dtype=np.float32, grad_mode: str = "mean"):
    """Split the COO by meta's user partition and build one stream per
    shard (``prepare_stream_sgd`` per shard, common tile, batch count
    padded to the max shard).

    Returns (ShardedStreamSGD, orders) where orders[d] maps shard d's
    stream position -> index into that shard's COO subset (for tests).
    """
    from ycnr_tpu_torch.models.sgd_stream import prepare_stream_sgd

    D, upd = meta.n_shards, meta.upd
    train_u = np.asarray(train_u)
    train_i = np.asarray(train_i)
    train_r = np.asarray(train_r, np.float32)
    shard_of = meta.user_local[train_u] // upd
    local_of = meta.user_local[train_u] % upd
    b_local = max(1, batch_size // D)
    tdtype = torch.float64 if np_dtype(dtype) == np.float64 else torch.float32

    datas, orders = [], []
    for d in range(D):
        p = np.nonzero(shard_of == d)[0]
        sd, od = prepare_stream_sgd(local_of[p], train_i[p], train_r[p],
                                    b_local, upd, meta.n_items,
                                    seed=seed + d, dtype=tdtype,
                                    grad_mode=grad_mode, device=False)
        datas.append(sd)
        orders.append(od)
    tile = max(sd.tile for sd in datas)
    nb = max(sd.ul.shape[0] for sd in datas)
    # re-derive each shard's (u_lo, ul) for the COMMON tile arithmetically
    # (us = ul + u_lo per batch) instead of re-running the whole prepare
    for d, sd in enumerate(datas):
        ul = np.asarray(sd.ul)
        lo = np.asarray(sd.u_lo)
        us = ul.astype(np.int64) + lo.astype(np.int64)[:, None]
        first = us.min(axis=1)
        lo2 = np.minimum(first, upd + 1 - tile).astype(np.int32)
        ul2 = (us - lo2[:, None].astype(np.int64)).astype(np.int32)
        datas[d] = sd._replace(ul=ul2, u_lo=lo2, tile=tile)

    def stack(field, pad_value, dt):
        out = np.full((D, nb, b_local), pad_value, dt)
        for d, sd in enumerate(datas):
            a = np.asarray(getattr(sd, field))
            out[d, : a.shape[0]] = a
        return out

    lo = np.zeros((D, nb), np.int32)
    for d, sd in enumerate(datas):
        a = np.asarray(sd.u_lo)
        lo[d, : len(a)] = a
    dt = np_dtype(dtype)
    data = ShardedStreamSGD(
        ul=stack("ul", 0, np.int32),
        ib=stack("ib", meta.n_items, np.int32),
        rb=stack("rb", 0.0, np.float64).astype(dt),
        wu=stack("wu", 0.0, np.float64).astype(dt),
        wi=stack("wi", 0.0, np.float64).astype(dt),
        u_lo=lo, tile=tile, grad_mode=grad_mode)
    return data, orders


def put_stream(data: ShardedStreamSGD, mesh: Mesh) -> ShardedStreamSGD:
    """This rank's stream as tensors on its device (``u_lo`` on the
    host, a list of tile starts)."""
    d, dev = mesh.rank, mesh.device

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(np.asarray(x)[d]),
                               device=dev)

    return ShardedStreamSGD(t(data.ul).long(), t(data.ib).long(), t(data.rb),
                            t(data.wu), t(data.wi),
                            np.asarray(data.u_lo)[d].tolist(), data.tile,
                            data.grad_mode)


def sharded_sgd_stream_epoch(mesh: Mesh, st: ShardedState,
                             data: ShardedStreamSGD, lam: float, lr,
                             order=None, seed: int = 0,
                             epoch: int = 0) -> ShardedState:
    """One stream epoch on the mesh in batch order ``order`` (the same on
    every rank; drawn from ``seed + 7919 * epoch`` when None): per batch a
    local tile update and one all-reduce of the V / b_i delta."""
    dev = st.U.device
    nb = data.ul.shape[0]
    if order is None:
        gen = torch.Generator(dev).manual_seed(int(seed) + 7919 * int(epoch))
        order = torch.randperm(nb, generator=gen, device=dev)
    k = st.U.shape[1]
    tile = data.tile
    lr, lam_ = float(lr), float(lam)
    Ue = torch.cat([st.U, st.bu[:, None]], dim=1)
    Ve = torch.cat([st.V, st.bi[:, None]], dim=1)
    one_col = _bias_col(Ue)
    dV = torch.empty_like(Ve)
    mu = st.mu
    for b in _host_order(order):
        lo = data.u_lo[b]
        Ut = Ue[lo:lo + tile]
        ulb, ibb = data.ul[b], data.ib[b]
        ue = row_gather(Ut, ulb)
        ve = row_gather(Ve, ibb)
        pred = mu + ue[:, k] + ve[:, k] + (ue[:, :k] * ve[:, :k]).sum(1)
        e = data.rb[b] - pred  # weights carry the padding mask
        ve1 = ve * (1 - one_col) + one_col
        ue1 = ue * (1 - one_col) + one_col
        gu = (lr * data.wu[b])[:, None] * (e[:, None] * ve1 - lam_ * ue)
        gv = (lr * data.wi[b])[:, None] * (e[:, None] * ue1 - lam_ * ve)
        scatter_add_(Ut, ulb, gu)
        # V / b_i deltas cross user shards: all-reduce per batch (P3)
        dV.zero_()
        scatter_add_(dV, ibb, gv)
        Ve += mesh.all_reduce_(dV)
    return ShardedState(Ue[:, :k].contiguous(), Ve[:, :k].contiguous(),
                        Ue[:, k].contiguous(), Ve[:, k].contiguous(), st.mu)

"""Stream-SGD: the SGD epoch over a user-sorted stream (counterpart of the
resident flat-stream path of ``ycnr_tpu/models/sgd_stream.py``).

``models/sgd.py`` processes uniformly-shuffled batches: two random-row
gathers and four scatter-adds per batch. This module keeps the exact
per-batch update MATH (gradients at batch-start parameters, duplicate
handling per grad_mode) and restructures the epoch as the JAX package
does:

* The stream is sorted by user once at prepare time, batches are
  consecutive segments, and each batch's rows are then re-sorted by item.
  The user rows a batch touches live in one contiguous window, so the U
  side works on a tile ``Ue[lo:lo + tile]``: a slice view that is gathered
  from and accumulated into in place, with tile-local indices.
* User/item biases ride as an extra factor column for the epoch (built
  once per epoch, split at the end), so the bias gathers and updates fuse
  into the factor-row ops.
* grad_mode="mean"/"capped" weights depend only on batch composition,
  which is fixed at prepare time: they are precomputed on the host.
* Per-epoch stochasticity comes from permuting the BATCH ORDER every
  epoch.

"sum" mode is numerically equivalent to ``models/sgd.sgd_epoch`` run with
the stream order as its permutation (the same terms, in another
association order). The stream order CONCENTRATES each user's ratings,
the case "sum" handles badly while plain "mean" under-steps hot entities,
so the default is "capped" (weight min(multiplicity, cap)/multiplicity)
plus round-robin pass striping.

The host code that builds the stream is the JAX package's, copied as it
stands. The ``lax.scan`` over batches is a host loop: the batch order and
the tile starts ``u_lo`` stay on the host, so no step reads a device value
back.
The factor-row gathers go through ``ops.row_gather`` (rows of k + 1
elements: the kernel's 4-byte path for an odd k + 1 in f32), the
segment sums are ``models.base.scatter_add_``, whose order is fixed, so the
same batch order gives the same factors bit for bit.

The out-of-core epoch over a host-resident stream and the compact-wire
epochs of the JAX module are not ported yet: ``StreamSGD.epoch`` raises
``NotImplementedError`` for them.

Random numbers cannot match JAX's: ``StreamSGD.epoch`` draws the batch
order from ``torch.Generator(device).manual_seed(seed + 7919 *
epoch_idx)``; parity tests pass ``order`` explicitly to both packages.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ycnr_tpu_torch import resolve_device
from ycnr_tpu_torch.models.base import MFState, scatter_add_
from ycnr_tpu_torch.ops.row_gather import row_gather


class StreamSGDData(NamedTuple):
    """User-sorted, per-batch-item-sorted stream as [NB, B] tensors.

    Padding rows carry item id n_items (the zero trash row) and weight 0.
    ``ul`` is the LOCAL user row within the batch's U-tile (global id -
    u_lo); ``u_lo`` is each batch's tile start, clamped so a full
    [tile, k+1] slice stays in bounds: a host NumPy array, so a tile is a
    plain slice. ``wu``/``wi`` are the per-row update weights (mask for
    "sum", mask/multiplicity for "mean") — precomputed because batch
    composition is static. With ``device=False`` at prepare time every
    array is host NumPy (the out-of-core form, not trainable yet).
    """

    ul: torch.Tensor  # [NB, B] int64 local user row in the batch tile
    ib: torch.Tensor  # [NB, B] int64 global item id, sorted per batch
    rb: torch.Tensor  # [NB, B] float rating (pad -> 0)
    wu: torch.Tensor  # [NB, B] float user-side update weight (pad -> 0)
    wi: torch.Tensor  # [NB, B] float item-side update weight (pad -> 0)
    u_lo: np.ndarray  # [NB] int32 tile start row (host)
    n_real: int
    tile: int  # static tile height (max user span over batches, padded)
    grad_mode: str  # weights were built for this mode


def prepare_stream_sgd(train_u, train_i, train_r, batch_size: int,
                       n_users: int, n_items: int, seed: int = 0,
                       dtype=torch.float32, grad_mode: str = "capped",
                       tile: int | None = None, passes: int | None = None,
                       cap: int = 32, device=None):
    """Build the stream (host, once per dataset).

    Returns (StreamSGDData, order) where ``order`` maps stream position ->
    original padded-COO position (exposed so tests can replay the exact
    stream through models/sgd.sgd_epoch for parity). ``tile`` forces a
    specific tile height (>= the computed one; a sharded preparation aligns
    shards to a common tile). ``device``: None puts the stream on the card
    (``resolve_device``), a device puts it there, False keeps it on the
    host as NumPy (for the out-of-core epoch).

    ``passes`` (default min(16, n_batches)) stripes each user's shuffled
    ratings round-robin over that many user-sorted sub-streams. Without it
    a hot user's whole history lands in ONE batch, so "mean" mode gives
    them a single averaged step per epoch — measured to slow convergence
    badly vs the shuffled-batch path (a user rated c times gets ~c*B/nnz
    sequential steps there). R passes restore R sequential mean steps per
    hot user per epoch while every batch still covers a contiguous user
    window (the tile property the whole layout exists for); passes=1
    reproduces the plain user-major stream.
    """
    n = len(train_r)
    if n >= 2**31 - 1:
        raise ValueError("stream prep indexes positions in int32")
    nb = -(-n // batch_size)
    n_pad = nb * batch_size
    # every host stage here is page-fault/bandwidth bound on big datasets
    # (flat profile, docs/KERNELS.md "Host-side build notes"), so indices
    # and ids are int32 throughout — same values, half the bytes
    u = np.full(n_pad, n_users, np.int32)
    i = np.full(n_pad, n_items, np.int32)
    r = np.zeros(n_pad, np.float32)
    u[:n], i[:n], r[:n] = train_u, train_i, train_r
    rng = np.random.default_rng(seed)
    # permute an int32 iota: identical sequence of swaps (and thus the
    # identical permutation) as permutation(n_pad), minus the int64 blob
    shuf = rng.permutation(np.arange(n_pad, dtype=np.int32))
    order = shuf[np.argsort(u[shuf], kind="stable")]
    us = u[order]
    R = min(16, nb) if passes is None else max(1, int(passes))
    if R > 1:
        # position within each user's (shuffled) run -> pass id; stable
        # re-sort by (pass, user) keeps user-major order within each pass
        run_starts = np.flatnonzero(
            np.r_[True, us[1:] != us[:-1]]).astype(np.int32)
        run_id = np.zeros(n_pad, np.int32)
        run_id[run_starts[1:]] = 1
        run_id = np.cumsum(run_id, dtype=np.int32)
        pos = np.arange(n_pad, dtype=np.int32) - run_starts[run_id]
        p = (pos % R).astype(np.int8 if R <= 127 else np.int32)
        # order is already user-sorted, so ONE stable sort by pass keeps
        # user-major order within each pass (a 3-key lexsort costs ~2x)
        order = order[np.argsort(p, kind="stable")]
        # pad every pass to a whole number of batches (sentinel -1 ->
        # trash ids): a batch straddling a pass boundary would otherwise
        # span the full user-id range and blow the tile to n_users
        pv = np.sort(p)
        seg_end = np.flatnonzero(np.r_[pv[1:] != pv[:-1], True]) + 1
        parts = []
        for ch in np.split(order, seg_end[:-1]):
            parts.append(ch)
            short = (-len(ch)) % batch_size
            if short:
                parts.append(np.full(short, -1, np.int32))
        order = np.concatenate(parts)
        nb = len(order) // batch_size
        n_pad = nb * batch_size

    def take(a, fill):
        out = a[np.maximum(order, 0)].copy()
        out[order < 0] = fill
        return out

    us = take(u, n_users)

    def _run_multiplicity(keys):
        """count of equal consecutive keys within each batch, broadcast per
        element (O(n)). Runs break at batch boundaries directly instead of
        via a composite (batch, key) int64 key — three full-length int64
        temporaries fewer on this page-fault-bound host."""
        brk = np.empty(len(keys), np.bool_)
        brk[0] = True
        np.not_equal(keys[1:], keys[:-1], out=brk[1:])
        brk[::batch_size] = True
        starts = np.flatnonzero(brk)
        lens = np.diff(np.r_[starts, len(keys)]).astype(np.int32)
        return np.repeat(lens, lens)

    # host weight dtype: f64 only when training in f64 (oracle parity);
    # f32 runs skip ~1 GB of f64 temporaries at Netflix scale
    wdt = np.float64 if dtype == torch.float64 else np.float32
    # user-side 1/multiplicity per batch, computed on the user-major
    # stream (user runs are contiguous within a batch: passes are padded
    # to batch boundaries above)
    if grad_mode in ("mean", "capped"):
        wu = wdt(1.0) / _run_multiplicity(us).astype(wdt)
    # re-sort each batch's rows by item id (keeps the item-side segment
    # sum on the sorted fast path with no runtime permute)
    isort = np.argsort(take(i, n_items).reshape(nb, batch_size), axis=1,
                       kind="stable")
    order = order.reshape(nb, batch_size)[
        np.arange(nb)[:, None], isort].reshape(-1)
    us, is_, rs = take(u, n_users), take(i, n_items), take(r, 0.0)

    first = us.reshape(nb, batch_size).min(axis=1)
    last = us.reshape(nb, batch_size).max(axis=1)
    need = int((last - first).max(initial=0)) + 1
    if tile is None:
        tile = min(-(-need // 8) * 8, n_users + 1)  # as the JAX package
    elif tile < min(need, n_users + 1):
        raise ValueError(f"tile override {tile} < required {need}")
    tile = min(tile, n_users + 1)
    u_lo = np.minimum(first, n_users + 1 - tile).astype(np.int32)
    ul = us - np.repeat(u_lo, batch_size)  # int32 - int32

    m = (is_ < n_items).astype(wdt)
    if grad_mode in ("mean", "capped"):
        # "mean": weight 1/mult (entity's batch update = mean of its row
        # grads — every entity gets effective lr*1 per batch). "capped":
        # weight min(mult, cap)/mult — effective lr*min(mult, cap),
        # matching the shuffled-batch "sum" path's natural multiplicity
        # (~c_u*B/nnz, bounded) without its hot-entity divergence;
        # measured to reproduce batched-sum convergence where "mean" is
        # several times slower per epoch.
        t = wdt(1.0) if grad_mode == "mean" else wdt(cap)
        wu_m = wu  # 1/mult from the pre-sort pass
        wu = (np.minimum(wdt(1.0) / wu_m, t) * wu_m).reshape(
            nb, batch_size)[np.arange(nb)[:, None], isort].reshape(-1) * m
        wi_m = wdt(1.0) / _run_multiplicity(is_).astype(wdt)
        wi = np.minimum(wdt(1.0) / wi_m, t) * wi_m * m
    else:
        wu = wi = m
    # device=False keeps the stream on host (numpy) for the out-of-core
    # epoch — device memory then holds only the factors
    if device is False:
        def put(a, dt=None):
            return np.ascontiguousarray(a if dt is None else a.astype(wdt))
    else:
        device = resolve_device(device, "prepare_stream_sgd()")

        def put(a, dt=None):
            t = torch.as_tensor(np.ascontiguousarray(a), device=device)
            return t.long() if dt is None else t.to(dt)
    data = StreamSGDData(
        ul=put(ul.reshape(nb, batch_size)),
        ib=put(is_.reshape(nb, batch_size).astype(np.int32)),
        rb=put(rs.reshape(nb, batch_size), dtype),
        wu=put(wu.reshape(nb, batch_size), dtype),
        wi=put(wi.reshape(nb, batch_size), dtype),
        u_lo=u_lo,
        n_real=n, tile=tile, grad_mode=grad_mode)
    return data, order


def _batch_update(Ue, Ve, mu, one_col, lam_, lr, tile: int,
                  ulb, ibb, rbb, wub, wib, lo: int):
    """THE single copy of the per-batch update math; updates ``Ue`` and
    ``Ve`` in place.

    Per rating: tile gather, V gather, tile segment-sum, item segment-sum.
    Biases ride as column k of the extended factor tables. ``lo`` is a
    host int, so the tile is a slice view of ``Ue``."""
    k = Ue.shape[1] - 1
    Ut = Ue[lo:lo + tile]
    ue = row_gather(Ut, ulb)  # [B, k+1] gather from the tile
    ve = row_gather(Ve, ibb)  # [B, k+1] gather from the item table
    pred = mu + ue[:, k] + ve[:, k] + (ue[:, :k] * ve[:, :k]).sum(1)
    e = rbb - pred  # weights carry the padding mask
    # gradient rows, uniform across factor cols and the bias col:
    # replacing the partner's bias col with 1 makes  e*partner - lam*own
    # compute the bias update in the same elementwise expression
    ve1 = ve * (1 - one_col) + one_col
    ue1 = ue * (1 - one_col) + one_col
    gu = (lr * wub)[:, None] * (e[:, None] * ve1 - lam_ * ue)
    gv = (lr * wib)[:, None] * (e[:, None] * ue1 - lam_ * ve)
    scatter_add_(Ut, ulb, gu)  # both gathers are done: batch-start values
    scatter_add_(Ve, ibb, gv)
    return Ue, Ve


def _bias_col(Ue):
    # [1, k+1] selector of the bias column (column k)
    k = Ue.shape[1] - 1
    return (torch.arange(k + 1, device=Ue.device)[None, :]
            == k).to(Ue.dtype)


def _host_order(order) -> list:
    """The epoch's batch order as a host list (one read-back per epoch if
    it was drawn on the device)."""
    if isinstance(order, torch.Tensor):
        return order.tolist()
    return np.asarray(order).tolist()


def stream_epoch_core(state: MFState, ul, ib, rb, wu, wi, u_lo, order,
                      lam, lr, tile: int) -> MFState:
    """One epoch over the stream in batch order ``order`` ([NB]
    permutation — reshuffled per epoch for stochasticity)."""
    lr, lam_ = float(lr), float(lam)
    # extended tables: factors with the bias as column k
    Ue = torch.cat([state.U, state.bu[:, None]], dim=1)
    Ve = torch.cat([state.V, state.bi[:, None]], dim=1)
    one_col = _bias_col(Ue)
    u_lo = np.asarray(u_lo).tolist()
    for b in _host_order(order):
        _batch_update(Ue, Ve, state.mu, one_col, lam_, lr, tile,
                      ul[b], ib[b], rb[b], wu[b], wi[b], u_lo[b])
    k = state.U.shape[1]
    return state._replace(U=Ue[:, :k].contiguous(), V=Ve[:, :k].contiguous(),
                          bu=Ue[:, k].contiguous(), bi=Ve[:, k].contiguous())


# the JAX package's jitted entry around the core; nothing is compiled here
sgd_stream_epoch = stream_epoch_core


class StreamSGD:
    """Engine-facing stream-SGD trainer (drop-in for models/sgd.BiasedSGD
    where the dataset was prepared with prepare_stream_sgd)."""

    def __init__(self, lam: float = 0.02, lr: float = 0.01,
                 lr_decay: float = 0.95, seed: int = 0,
                 grad_mode: str = "capped"):
        self.lam = float(lam)
        self.lr0 = float(lr)
        self.lr_decay = float(lr_decay)
        self.seed = seed
        self.grad_mode = grad_mode

    def lr_at(self, epoch: int) -> float:
        return self.lr0 * self.lr_decay**epoch

    def epoch(self, state: MFState, data, epoch_idx: int,
              order=None) -> MFState:
        """``data`` is a device-resident StreamSGDData. A host-resident
        stream (``device=False``) and the compact wire are the out-of-core
        forms, which are not ported: they raise."""
        if not isinstance(data, StreamSGDData):
            raise NotImplementedError(
                "the compact-wire stream epochs are not ported yet")
        if isinstance(data.ul, np.ndarray):
            raise NotImplementedError(
                "the out-of-core epoch over a host-resident stream is not "
                "ported yet: prepare the stream on a device")
        if data.grad_mode != self.grad_mode:
            raise ValueError(
                f"data was prepared for grad_mode={data.grad_mode!r}; "
                f"trainer wants {self.grad_mode!r} — re-run "
                f"prepare_stream_sgd with matching grad_mode")
        if order is None:
            dev = data.ul.device
            gen = torch.Generator(dev).manual_seed(
                self.seed + 7919 * epoch_idx)
            order = torch.randperm(data.ul.shape[0], generator=gen,
                                   device=dev)
        return sgd_stream_epoch(state, data.ul, data.ib, data.rb, data.wu,
                                data.wi, data.u_lo, order, self.lam,
                                self.lr_at(epoch_idx), data.tile)

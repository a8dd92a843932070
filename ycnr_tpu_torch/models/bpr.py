"""BPR-MF on the device: pairwise ranking for implicit feedback (Rendle
2009; counterpart of ``ycnr_tpu/models/bpr.py``).

The same deterministic mini-batch machinery as ``models/sgd.py``: per
batch, gradients are computed at batch-start parameters and scatter-added
(duplicates accumulate — ``np.add.at`` semantics, matching
``oracle.bpr_epoch_batched``).

Negative sampling: per epoch, one uniformly-drawn negative item per
observed (user, item) positive — drawn ON THE DEVICE, validated against a
packed rated-bits table ([n_users+1, ceil(n_items/32)] words, the same
bitfield trick as the serving mask). A collision (the "negative" is
actually rated) zero-weights that triple instead of resampling. The words
are held as int32 (torch has no full uint32 arithmetic): ``(w >> s) & 1``
reads bit s of either, bit 31 included. Same seed => bitwise-same factors:
the scatter-adds accumulate in a fixed order
(``models.base.scatter_add_``).

The JAX package's ``lax.scan`` is a host loop that reads no device value
back; the factor-row gathers ``Uf[ub]``, ``Vf[ib]``, ``Vf[jb]`` go through
``ops.row_gather`` (rows of k + 1 or k + 2 elements), the rated-bit word
lookup is plain indexing.

Random numbers cannot match JAX's: ``BPRTrainer.epoch`` draws negatives
and the permutation from ``torch.Generator(device).manual_seed(seed + 7919
* epoch_idx)``; parity tests pass ``perm`` and ``negs`` explicitly to both
packages.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ycnr_tpu_torch import resolve_device
from ycnr_tpu_torch.models.base import MFState, scatter_add_
from ycnr_tpu_torch.ops.row_gather import row_gather


class BPRData(NamedTuple):
    """Positive pairs padded to whole batches + the rated-bits table +
    the expected-multiplicity weight vectors (read by grad_mode="emean").
    Padding points at the trash rows (u = n_users, i = n_items) and is
    masked out of every update."""

    u: torch.Tensor      # [n_pad] int64
    i: torch.Tensor      # [n_pad] int64
    bits: torch.Tensor   # [n_users + 1, ceil(n_items/32)] int32 (uint32 bits)
    wu: torch.Tensor     # [n_users + 1] f32 1/max(1, E[user triples/batch])
    wi: torch.Tensor     # [n_items + 1] f32 1/max(1, E[item rows/batch])
    n_real: int


def pack_rated_bits(train_u, train_i, n_users: int, n_items: int):
    """Packed rated-set bitfield as uint32 words (host side, one pass over
    nnz): the native loop of ``csrc/ingest.cc`` where g++ built it, else
    ``np.bitwise_or.at`` (the same words)."""
    from ycnr_tpu_torch.data.native import pack_bits_native

    out = pack_bits_native(train_u, train_i, n_users, n_items)
    if out is not None:
        return out
    W = (int(n_items) + 31) // 32
    bits = np.zeros((int(n_users) + 1, W), np.uint32)
    u = np.asarray(train_u)
    i = np.asarray(train_i)
    np.bitwise_or.at(bits, (u, i // 32),
                     (np.uint32(1) << (i % 32).astype(np.uint32)))
    return bits


def expected_weights(train_u, train_i, batch_size: int, n_users: int,
                     n_items: int):
    """grad_mode="emean" weight vectors: 1/max(1, E[batch multiplicity]).

    E[user u triples per batch]  = deg_u * B / nnz
    E[item t rows per batch]     = deg_t * B / nnz  (as the positive)
                                 + B / n_items      (as a uniform negative)

    Deterministic and precomputable (unlike "mean"'s realized counts, which
    cost extra random per-row ops per triple on the device). Trash rows
    weigh 0."""
    nnz = max(len(np.asarray(train_u)), 1)
    # a batch holds at most min(B, nnz) REAL rows (smaller datasets fit in
    # one padded batch), so the expectation uses the effective batch size —
    # otherwise small-data runs underweight every update by B/nnz
    b_eff = min(int(batch_size), nnz)
    deg_u = np.bincount(np.asarray(train_u), minlength=n_users)
    deg_i = np.bincount(np.asarray(train_i), minlength=n_items)
    wu = np.zeros(int(n_users) + 1, np.float32)
    wi = np.zeros(int(n_items) + 1, np.float32)
    wu[:n_users] = 1.0 / np.maximum(deg_u * (b_eff / nnz), 1.0)
    wi[:n_items] = 1.0 / np.maximum(
        deg_i * (b_eff / nnz) + b_eff / n_items, 1.0)
    return wu, wi


def prepare_bpr_data(train_u, train_i, batch_size: int, n_users: int,
                     n_items: int, shuffle_rows_seed=None,
                     device=None) -> BPRData:
    """``shuffle_rows_seed``: one host-side row permutation applied before
    padding — used by the "batches" shuffle mode so its FIXED batch
    composition is a random partition rather than the file order (which
    for MovieLens exports is user-sorted: contiguous user runs would
    concentrate hot users in batches). ``device`` None means the card
    (``resolve_device``)."""
    device = resolve_device(device, "prepare_bpr_data()")
    n = len(train_u)
    if shuffle_rows_seed is not None:
        order = np.random.default_rng(shuffle_rows_seed).permutation(n)
        train_u = np.asarray(train_u)[order]
        train_i = np.asarray(train_i)[order]
    n_pad = int(-(-n // batch_size) * batch_size)
    u = np.full(n_pad, n_users, np.int32)
    i = np.full(n_pad, n_items, np.int32)
    u[:n], i[:n] = train_u, train_i
    bits = pack_rated_bits(train_u, train_i, n_users, n_items)
    wu, wi = expected_weights(train_u, train_i, batch_size, n_users,
                              n_items)

    def t(x):
        return torch.as_tensor(x, device=device)

    return BPRData(t(u).long(), t(i).long(), t(bits.view(np.int32)), t(wu),
                   t(wi), n)


_GRAD_MODES = ("sum", "mean", "emean")
_SHUFFLES = ("rows", "batches")


def check_shuffle(shuffle: str):
    """Shared by every shuffle-mode consumer so a config typo errors
    instead of silently training in "rows" mode."""
    if shuffle not in _SHUFFLES:
        raise ValueError(f"shuffle must be one of {_SHUFFLES}, got "
                         f"{shuffle!r}")


def _check_grad_mode(grad_mode: str):
    if grad_mode not in _GRAD_MODES:
        raise ValueError(f"grad_mode must be one of {_GRAD_MODES}, got "
                         f"{grad_mode!r} (a typo would silently train "
                         f"with 'sum' semantics otherwise)")


def fuse_bpr_state(U, V, bi, wu, wi, grad_mode: str = "emean"):
    """(Uf, Vf) with the extra columns the epoch loop carries:

        Uf = [U | 1 | wu?]        Vf = [V | bi | wi?]

    Column k (ones / bias) makes the fused dot produce x = U.(Vi-Vj) +
    (bi_i - bi_j) and makes the joint Vf update's bias column the exact
    b_i update (the stream-SGD trick). For grad_mode="emean" a second
    extra column carries the per-row expected-multiplicity weights ALONG
    WITH the factor gathers, so the weighting costs no extra per-row op;
    sum/mean modes skip it."""
    _check_grad_mode(grad_mode)
    dt = U.dtype
    cu = [U, torch.ones((U.shape[0], 1), dtype=dt, device=U.device)]
    cv = [V, bi[:, None].to(dt)]
    if grad_mode == "emean":
        cu.append(wu[:, None].to(dt))
        cv.append(wi[:, None].to(dt))
    return torch.cat(cu, dim=1), torch.cat(cv, dim=1)


def _apply_batch(Uf, Vf, bits, ub, ib, jb, n_users, lam, lr, grad_mode):
    """One batch: deltas at batch-start parameters, then the scatter-adds
    into ``Uf`` and ``Vf`` in place (the positive and the negative item
    rows in one pass over ``Vf``)."""
    du, dvi, dvj = bpr_batch_deltas(Uf, Vf, bits, ub, ib, jb, n_users, lam,
                                    lr, grad_mode)
    scatter_add_(Uf, ub, du)
    scatter_add_(Vf, torch.cat([ib, jb]), torch.cat([dvi, dvj]))


def bpr_epoch_core(U, V, bi, u, i, j, bits, wu, wi, lam, lr,
                   grad_mode: str):
    """Batched-triple loop. u/i/j are already permuted + reshaped to
    [n_batches, B]; wu/wi are the expected-weight vectors from BPRData.
    Returns (U, V, bi)."""
    n_users = U.shape[0] - 1
    k = U.shape[1]
    Uf, Vf = fuse_bpr_state(U, V, bi, wu, wi, grad_mode)
    for ub, ib, jb in zip(u, i, j):
        _apply_batch(Uf, Vf, bits, ub, ib, jb, n_users, float(lam),
                     float(lr), grad_mode)
    return (Uf[:, :k].contiguous(), Vf[:, :k].contiguous(),
            Vf[:, k].to(bi.dtype).contiguous())


def bpr_batch_deltas(Uf, Vf, bits, ub, ib, jb, pad_row, lam, lr,
                     grad_mode: str):
    """One batch's per-row update terms over the FUSED arrays — the single
    copy of the BPR math. Returns (du, dvi, dvj), each [B, k + extra];
    callers scatter du at ub, dvi at ib, dvj at jb. ``pad_row`` is the
    first padding user index (n_users on one device).

    grad_mode: "sum" (per-sample accumulation, oracle-exact), "mean"
    (realized batch multiplicities), "emean" (expected multiplicities from
    the fused weight columns; see expected_weights)."""
    _check_grad_mode(grad_mode)
    extra = 2 if grad_mode == "emean" else 1
    k = Uf.shape[1] - extra
    dt, dev = Uf.dtype, Uf.device
    # column roles: 0..k-1 factors, k ones/bias, (emean) k+1 weights
    colU = torch.cat([torch.ones(k, dtype=dt, device=dev),
                      torch.zeros(extra, dtype=dt, device=dev)])
    colV = torch.cat([torch.ones(k + 1, dtype=dt, device=dev),
                      torch.zeros(extra - 1, dtype=dt, device=dev)])
    pad = ub < pad_row
    # collision test: is j in u's rated set? (padding rows of `bits` are
    # all-zero, so padded samples read bit 0 — the pad mask kills them)
    word = bits[ub.clamp(max=bits.shape[0] - 1), jb // 32]
    hit = (word >> (jb % 32).to(torch.int32)) & 1
    m = (pad & (hit == 0)).to(dt)
    Uu = row_gather(Uf, ub)
    Vi = row_gather(Vf, ib)
    Vj = row_gather(Vf, jb)
    # the dot runs over factor+bias columns only
    x = (Uu[:, :k + 1] * (Vi[:, :k + 1] - Vj[:, :k + 1])).sum(1)
    s = m * torch.sigmoid(-x)
    if grad_mode == "mean":
        cu = scatter_add_(torch.zeros(Uf.shape[0], dtype=dt, device=dev),
                          ub, m)
        ci = scatter_add_(torch.zeros(Vf.shape[0], dtype=dt, device=dev),
                          torch.cat([ib, jb]), torch.cat([m, m]))
        wu = m / cu[ub].clamp_min(1.0)
        wi = m / ci[ib].clamp_min(1.0)
        wj = m / ci[jb].clamp_min(1.0)
    elif grad_mode == "emean":
        # the weights arrived with the factor gathers — no extra op
        wu = m * Uu[:, k + 1]
        wi = m * Vi[:, k + 1]
        wj = m * Vj[:, k + 1]
    else:
        wu = wi = wj = m
    du = colU * (lr * wu[:, None] * (s[:, None] * (Vi - Vj) - lam * Uu))
    dvi = colV * (lr * wi[:, None] * (s[:, None] * Uu - lam * Vi))
    dvj = colV * (lr * wj[:, None] * (-s[:, None] * Uu - lam * Vj))
    return du, dvi, dvj


def bpr_epoch(state: MFState, data: BPRData, perm, negs, lam: float, lr,
              batch_size: int, grad_mode: str = "sum") -> MFState:
    """One epoch over all batches in the order given by ``perm`` with the
    per-triple negatives ``negs`` (same length as the padded positives —
    pass the same arrays to the oracle for parity runs).

    Math per oracle.bpr_epoch_batched:
        x = U[u].(V[i]-V[j]) + bi[i] - bi[j];  s = sigmoid(-x)
    with collision-masked, grad_mode-weighted scatter-added updates. bu and
    mu stay untouched (BPR scores are per-user-invariant in them; the item
    bias captures popularity).
    """
    dev = state.U.device
    perm = torch.as_tensor(perm, device=dev).long()
    negs = torch.as_tensor(negs, device=dev).long()
    u = data.u[perm].view(-1, batch_size)
    i = data.i[perm].view(-1, batch_size)
    j = negs.view(-1, batch_size)
    U, V, bi = bpr_epoch_core(state.U, state.V, state.bi, u, i, j,
                              data.bits, data.wu, data.wi, lam, lr,
                              grad_mode)
    return state._replace(U=U, V=V, bi=bi)


def bpr_epoch_batches_core(U, V, bi, u2, i2, border, j2, bits, wu, wi,
                           lam, lr, grad_mode: str):
    """"batches" shuffle-mode epoch: u2/i2 are the prepared [NB, B]
    positives, border the per-epoch batch-order permutation (host ints, or
    a tensor read back once), j2 [NB, B] fresh negatives. One [B] row view
    per step — no permuted copy of the stream."""
    n_users = U.shape[0] - 1
    k = U.shape[1]
    Uf, Vf = fuse_bpr_state(U, V, bi, wu, wi, grad_mode)
    border = (border.tolist() if isinstance(border, torch.Tensor)
              else np.asarray(border).tolist())
    for step, bidx in enumerate(border):
        _apply_batch(Uf, Vf, bits, u2[bidx], i2[bidx], j2[step], n_users,
                     float(lam), float(lr), grad_mode)
    return (Uf[:, :k].contiguous(), Vf[:, :k].contiguous(),
            Vf[:, k].to(bi.dtype).contiguous())


def bpr_epoch_batches(state: MFState, data: BPRData, border, negs,
                      lam: float, lr, batch_size: int,
                      grad_mode: str = "sum") -> MFState:
    """One epoch in "batches" shuffle mode: batch COMPOSITION is fixed at
    prepare time (rows chunked in prepared order — see prepare_bpr_data's
    shuffle_rows_seed) and only the batch ORDER reshuffles per epoch,
    while negatives stay fresh per epoch. Skips the per-epoch full-row
    device permutation and its two apply-gathers. The default
    (BPRConfig.shuffle).
    """
    negs = torch.as_tensor(negs, device=state.U.device).long()
    u2 = data.u.view(-1, batch_size)
    i2 = data.i.view(-1, batch_size)
    j2 = negs.view(-1, batch_size)
    U, V, bi = bpr_epoch_batches_core(
        state.U, state.V, state.bi, u2, i2, border, j2, data.bits,
        data.wu, data.wi, lam, lr, grad_mode)
    return state._replace(U=U, V=V, bi=bi)


class BPRTrainer:
    """Engine-facing BPR trainer: per-epoch shuffle + fresh on-device
    negative draws, lr decay at the epoch barrier (mirrors BiasedSGD)."""

    def __init__(self, lam: float = 0.01, lr: float = 0.05,
                 lr_decay: float = 0.98, batch_size: int = 8192,
                 seed: int = 0, grad_mode: str = "sum",
                 shuffle: str = "rows"):
        check_shuffle(shuffle)
        self.lam = float(lam)
        self.lr0 = float(lr)
        self.lr_decay = float(lr_decay)
        self.batch_size = int(batch_size)
        self.seed = seed
        self.grad_mode = grad_mode
        self.shuffle = shuffle

    def lr_at(self, epoch: int) -> float:
        return self.lr0 * self.lr_decay**epoch

    def epoch(self, state: MFState, data: BPRData, epoch_idx: int,
              perm=None, negs=None) -> MFState:
        n_pad = data.u.shape[0]
        n_perm = (n_pad // self.batch_size if self.shuffle == "batches"
                  else n_pad)
        if (perm is None) != (negs is None):
            raise ValueError("pass perm AND negs together (parity runs) "
                             "or neither (fresh per-epoch draws)")
        if perm is not None and len(perm) != n_perm:
            raise ValueError(
                f"perm length {len(perm)} does not match shuffle="
                f"{self.shuffle!r} (expected {n_perm}: batch-order "
                f"indices for 'batches', row indices for 'rows')")
        if perm is None:
            dev = data.u.device
            gen = torch.Generator(dev).manual_seed(
                self.seed + 7919 * epoch_idx)
            negs = torch.randint(0, state.n_items, (n_pad,), generator=gen,
                                 device=dev)
            perm = torch.randperm(n_perm, generator=gen, device=dev)
        if self.shuffle == "batches":
            return bpr_epoch_batches(state, data, perm, negs, self.lam,
                                     self.lr_at(epoch_idx),
                                     self.batch_size, self.grad_mode)
        return bpr_epoch(state, data, perm, negs, self.lam,
                         self.lr_at(epoch_idx), self.batch_size,
                         self.grad_mode)

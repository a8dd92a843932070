"""Biased SGD-MF on the device (counterpart of ``ycnr_tpu/models/sgd.py``;
SURVEY.md C10/M3, Appendix A: Funk/Koren).

Deterministic mini-batched SGD, as there: per batch, gradients are computed
at batch-start parameters and scatter-added (duplicate users/items within a
batch accumulate, ``np.add.at`` semantics, which
``oracle.sgd_epoch_batched`` implements). Same seed => bitwise same
factors: the scatter-adds accumulate in a fixed order
(``models.base.scatter_add_``).

The JAX package's ``lax.scan`` over batches is a host loop here that never
reads a device value back; the factor-row gathers ``U[ub]``, ``V[ib]`` go
through ``ops.row_gather`` (the hand-written kernel on CUDA, plain indexing
on the CPU); the state is updated in place, where the JAX epoch donates it.

Random numbers cannot match JAX's: ``BiasedSGD.epoch`` draws its
permutation from ``torch.Generator(device).manual_seed(seed + 7919 *
epoch_idx)`` where the JAX package uses ``jax.random.key`` of the same
number. Parity tests pass ``perm`` explicitly to both packages;
free-running trajectories agree within a band, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ycnr_tpu_torch import resolve_device
from ycnr_tpu_torch.models.base import MFState, scatter_add_
from ycnr_tpu_torch.ops.row_gather import row_gather


class SGDData(NamedTuple):
    """Train COO padded to a whole number of batches (tensors on the
    device). Padding points at the trash rows and is masked out of every
    update."""

    u: torch.Tensor  # [n_pad] int64
    i: torch.Tensor  # [n_pad] int64
    r: torch.Tensor  # [n_pad] float
    n_real: int


def prepare_sgd_data(train_u, train_i, train_r, batch_size: int,
                     n_users: int, n_items: int, dtype=torch.float32,
                     device=None) -> SGDData:
    """``device`` None means the card (``resolve_device``)."""
    device = resolve_device(device, "prepare_sgd_data()")
    n = len(train_r)
    n_pad = int(-(-n // batch_size) * batch_size)
    u = np.full(n_pad, n_users, np.int32)
    i = np.full(n_pad, n_items, np.int32)
    r = np.zeros(n_pad, np.float32)
    u[:n], i[:n], r[:n] = train_u, train_i, train_r
    return SGDData(torch.as_tensor(u, device=device).long(),
                   torch.as_tensor(i, device=device).long(),
                   torch.as_tensor(r, device=device).to(dtype), n)


def sgd_epoch(state: MFState, data: SGDData, perm, lam: float, lr: float,
              batch_size: int, grad_mode: str = "sum") -> MFState:
    """One epoch over all batches in the order given by ``perm``, which
    permutes the padded COO; padding rides along and is masked. Updates
    ``state``'s tensors in place and returns the state.

    grad_mode:
      "sum"  — duplicates within a batch accumulate (per-sample SGD
               semantics; the oracle's)
      "mean" — each entity's accumulated update is divided by its batch
               multiplicity: a hot user can appear hundreds of times in a
               large batch, and "sum" then takes a step hundreds of times
               larger than intended and diverges.
    """
    if grad_mode not in ("sum", "mean"):
        raise ValueError(f"grad_mode must be 'sum' or 'mean', got "
                         f"{grad_mode!r}")
    U, V, bu, bi, mu = state
    dev, dt = U.device, U.dtype
    perm = torch.as_tensor(perm, device=dev).long()
    u = data.u[perm].view(-1, batch_size)
    i = data.i[perm].view(-1, batch_size)
    r = data.r[perm].view(-1, batch_size)
    n_users, n_items = state.n_users, state.n_items
    lr, lam = float(lr), float(lam)
    for ub, ib, rb in zip(u, i, r):
        Uu = row_gather(U, ub)  # [B, k]
        Vi = row_gather(V, ib)
        buu = bu[ub]
        bii = bi[ib]
        pred = mu + buu + bii + (Uu * Vi).sum(1)
        m = (ub < n_users).to(dt)  # padding mask
        e = (rb - pred) * m
        if grad_mode == "mean":
            cu = scatter_add_(torch.zeros(n_users + 1, dtype=dt, device=dev),
                              ub, m)
            ci = scatter_add_(torch.zeros(n_items + 1, dtype=dt, device=dev),
                              ib, m)
            wu = m / cu[ub].clamp_min(1.0)
            wi = m / ci[ib].clamp_min(1.0)
        else:
            wu = wi = m
        # updates per Appendix A; every term masked so trash rows stay zero
        scatter_add_(U, ub, lr * wu[:, None] * (e[:, None] * Vi - lam * Uu))
        scatter_add_(V, ib, lr * wi[:, None] * (e[:, None] * Uu - lam * Vi))
        scatter_add_(bu, ub, lr * wu * (e - lam * buu))
        scatter_add_(bi, ib, lr * wi * (e - lam * bii))
    return state


class BiasedSGD:
    """Engine-facing SGD trainer with per-epoch lr decay (the reference
    decays the learning rate at the epoch barrier, call stack 3.3)."""

    def __init__(self, lam: float = 0.02, lr: float = 0.01,
                 lr_decay: float = 0.95, batch_size: int = 4096,
                 seed: int = 0, grad_mode: str = "sum"):
        self.lam = float(lam)
        self.lr0 = float(lr)
        self.lr_decay = float(lr_decay)
        self.batch_size = int(batch_size)
        self.seed = seed
        self.grad_mode = grad_mode

    def lr_at(self, epoch: int) -> float:
        return self.lr0 * self.lr_decay**epoch

    def epoch(self, state: MFState, data: SGDData, epoch_idx: int,
              perm=None) -> MFState:
        if perm is None:
            dev = data.u.device
            gen = torch.Generator(dev).manual_seed(
                self.seed + 7919 * epoch_idx)
            perm = torch.randperm(data.u.shape[0], generator=gen, device=dev)
        return sgd_epoch(state, data, perm, self.lam, self.lr_at(epoch_idx),
                         self.batch_size, self.grad_mode)

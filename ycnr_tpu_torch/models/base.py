"""Shared factor-model state (counterpart of ``ycnr_tpu/models/base.py``).

Padding convention, as in the JAX package: factor matrices carry one
trailing all-zero row ([n+1, k]) and bias vectors one trailing zero
([n+1]); layouts point padding slots at those rows, so they contribute
nothing and the solvers keep them at zero.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ycnr_tpu_torch import resolve_device
from ycnr_tpu_torch.ops.layout import BlockedCSR


class MFState(NamedTuple):
    """Factors + biases. ALS/iALS keep biases and mu at zero."""

    U: torch.Tensor  # [n_users + 1, k], last row zero
    V: torch.Tensor  # [n_items + 1, k], last row zero
    bu: torch.Tensor  # [n_users + 1], last entry zero
    bi: torch.Tensor  # [n_items + 1], last entry zero
    mu: torch.Tensor  # 0-d global mean (0 for ALS/iALS)

    @property
    def n_users(self) -> int:
        return self.U.shape[0] - 1

    @property
    def n_items(self) -> int:
        return self.V.shape[0] - 1

    @property
    def rank(self) -> int:
        return self.U.shape[1]


def init_state(n_users: int, n_items: int, rank: int, seed: int = 0,
               scale: float = 0.1, mu: float = 0.0,
               dtype=torch.float32, device=None) -> MFState:
    """Random-normal factor init from NumPy's ``default_rng(seed)``, drawn
    exactly as the JAX package draws it, so both start from the same
    factors. ``device`` None means the card (``resolve_device``)."""
    device = resolve_device(device, "init_state()")
    rng = np.random.default_rng(seed)
    U = np.zeros((n_users + 1, rank), np.float64)
    V = np.zeros((n_items + 1, rank), np.float64)
    U[:n_users] = rng.normal(0.0, scale, (n_users, rank))
    V[:n_items] = rng.normal(0.0, scale, (n_items, rank))
    return state_from_numpy(U, V, np.zeros(n_users + 1), np.zeros(n_items + 1),
                            mu, device=device, dtype=dtype)


def state_from_numpy(U, V, bu, bi, mu, device=None,
                     dtype=torch.float32) -> MFState:
    """Wrap PADDED NumPy arrays (``np.asarray(jax_state.U)`` etc., trailing
    zero rows included) as the port's MFState. The JAX package's function
    of this name takes unpadded arrays; this one carries weights across.
    ``device`` None means the card (``resolve_device``)."""
    device = resolve_device(device, "state_from_numpy()")
    def t(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    return MFState(t(U), t(V), t(bu), t(bi), t(mu))


def to_numpy(state: MFState):
    """(U, V, bu, bi, mu) as padded NumPy arrays (inverse of
    ``state_from_numpy``)."""
    return tuple(x.detach().cpu().numpy() for x in state)


def grow_state(state: MFState, n_users: int, n_items: int, seed: int = 0,
               scale: float = 0.1) -> MFState:
    """Warm-start growth: extend a trained state to a larger catalog.

    New entity rows get the same random-normal init as ``init_state``, from
    a stream derived from the seed and the old and new dims
    (``SeedSequence([seed, ou, oi, n_users, n_items])``, as the JAX package
    draws it, so grown rows are bit-equal); existing rows and biases are
    carried through float32 as there; the trailing zero rows are kept.
    Shrinking is refused: entity indices are positional. The result lies
    on the state's device."""
    ou, oi, k = state.n_users, state.n_items, state.rank
    if n_users < ou or n_items < oi:
        raise ValueError(
            f"grow_state cannot shrink: checkpoint has {ou} users/{oi} "
            f"items, dataset has {n_users}/{n_items}")
    if n_users == ou and n_items == oi:
        return state
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, ou, oi, n_users, n_items]))

    def f32(x):
        return x.detach().float().cpu().numpy()

    U = np.zeros((n_users + 1, k), np.float64)
    V = np.zeros((n_items + 1, k), np.float64)
    U[:ou] = f32(state.U)[:ou]
    V[:oi] = f32(state.V)[:oi]
    U[ou:n_users] = rng.normal(0.0, scale, (n_users - ou, k))
    V[oi:n_items] = rng.normal(0.0, scale, (n_items - oi, k))
    bu = np.zeros(n_users + 1, np.float64)
    bi = np.zeros(n_items + 1, np.float64)
    bu[:ou] = f32(state.bu)[:ou]
    bi[:oi] = f32(state.bi)[:oi]
    grown = state_from_numpy(U, V, bu, bi, 0.0, device=state.U.device,
                             dtype=state.U.dtype)
    return grown._replace(mu=state.mu)


def zero_cold_entities(state: MFState, train_u, train_i) -> MFState:
    """Zero the factor/bias rows of entities with no training ratings, so
    a never-rated entity solves and serves as exactly 0."""
    au = np.zeros(state.U.shape[0], bool)
    au[np.asarray(train_u)] = True
    ai = np.zeros(state.V.shape[0], bool)
    ai[np.asarray(train_i)] = True
    au = torch.as_tensor(au, device=state.U.device)
    ai = torch.as_tensor(ai, device=state.V.device)
    zero = torch.zeros((), dtype=state.U.dtype, device=state.U.device)
    return state._replace(
        U=torch.where(au[:, None], state.U, zero),
        V=torch.where(ai[:, None], state.V, zero),
        bu=torch.where(au, state.bu, zero),
        bi=torch.where(ai, state.bi, zero),
    )


def device_layout(layout: BlockedCSR, dtype=torch.float32,
                  device=None) -> BlockedCSR:
    """Move a host ``build_blocked_csr`` layout into tensors on ``device``
    (None: the card, ``resolve_device``): indices as they are (int32),
    ratings and counts cast to ``dtype``."""
    device = resolve_device(device, "device_layout()")
    def t(x, dt=None):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    return BlockedCSR(
        other_idx=t(layout.other_idx),
        rating=t(layout.rating, dtype),
        chunk_seg=t(layout.chunk_seg),
        entity_ids=t(layout.entity_ids),
        entity_cnt=t(layout.entity_cnt, dtype),
    )


def scatter_add_(table: torch.Tensor, idx: torch.Tensor,
                 delta: torch.Tensor) -> torch.Tensor:
    """``table[idx] += delta`` in place, duplicates accumulating (the JAX
    package's ``.at[idx].add``), in an order that is the same on every
    run: the SGD and BPR trainers promise the same factors bit for bit
    from the same seed. On CUDA ``index_add_`` adds with atomics in no
    fixed order; ``index_put_(accumulate=True)`` sorts the indices
    (stably) and adds each row's terms in that order. On the CPU it is
    the other way round: ``index_put_(accumulate=True)`` adds float32 terms
    from several threads with atomics (400,000 terms into 50 rows gave
    other bits in 7 of 8 repeats on 4 threads, torch 2.13), while
    ``index_add_`` walks the indices in order on one thread."""
    if table.is_cuda:
        return table.index_put_((idx,), delta, accumulate=True)
    return table.index_add_(0, idx, delta)


def unpad(state: MFState):
    """Back to plain NumPy without the padding rows."""
    U, V, bu, bi, mu = to_numpy(state)
    return U[:-1], V[:-1], bu[:-1], bi[:-1], float(mu)


def predict(state: MFState, user_idx, item_idx) -> torch.Tensor:
    """r_hat = mu + b_u + b_i + p_u . q_i."""
    return (state.mu + state.bu[user_idx] + state.bi[item_idx]
            + (state.U[user_idx] * state.V[item_idx]).sum(-1))


_RMSE_CHUNK = 1 << 21  # rows per chunk: bounds the two [chunk, k] gathers


def rmse_padded(state: MFState, pu, pi, pr, n_real) -> torch.Tensor:
    """RMSE over a ``pad_coo``-padded held-out COO.

    Padding rows point at the trash rows; with mu possibly nonzero the
    prediction there is mu, so padding is masked by index. Large COOs are
    summed chunk by chunk, in order, as the reference's scan does.
    """
    dev = state.U.device
    pu, pi, pr = (torch.as_tensor(x, device=dev) for x in (pu, pi, pr))
    pr = pr.to(state.U.dtype)
    total = torch.zeros((), dtype=state.U.dtype, device=dev)
    for s in range(0, pu.shape[0], _RMSE_CHUNK):
        u = pu[s:s + _RMSE_CHUNK].long()
        i = pi[s:s + _RMSE_CHUNK].long()
        err = pr[s:s + _RMSE_CHUNK] - predict(state, u, i)
        err = torch.where(u < state.n_users, err, 0.0)
        total = total + (err * err).sum()
    return torch.sqrt(total / max(int(n_real), 1))

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
                  device="cpu") -> BlockedCSR:
    """Move a host ``build_blocked_csr`` layout into tensors on ``device``:
    indices as they are (int32), ratings and counts cast to ``dtype``."""
    def t(x, dt=None):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    return BlockedCSR(
        other_idx=t(layout.other_idx),
        rating=t(layout.rating, dtype),
        chunk_seg=t(layout.chunk_seg),
        entity_ids=t(layout.entity_ids),
        entity_cnt=t(layout.entity_cnt, dtype),
    )


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

"""Bucketed solve phases for ALS-WR and iALS (counterpart of
``ycnr_tpu/models/bucketed_phase.py``).

The layout is ``ycnr_tpu.ops.bucketed.build_bucketed``'s, unchanged: every
entity of a group owns exactly R rating slots, so its Gram matrix is one
batched product over the R axis. A phase walks each group block by block:
gather the other factor's rows, build the normal equations, run the
guarded batched solve (K1 on CUDA) and write the rows back.

The JAX package's scans become Python loops. A phase writes its solved rows
into ``E`` in place: blocks of one phase read only the other factor, so the
order of the writes does not matter, and padding slots all write the
trash row with rows that solve to exactly 0.
"""

from __future__ import annotations

from typing import Optional

import torch

from ycnr_tpu_torch.models.base import MFState, rmse_padded
from ycnr_tpu_torch.ops.gram import guarded_batched_solve
from ycnr_tpu_torch.shared import BucketedCSR, BucketGroup


def device_bucketed(groups, dtype=torch.float32,
                    device="cpu") -> BucketedCSR:
    """Move a host ``build_bucketed`` layout into tensors (indices as int64,
    ratings and counts in ``dtype``)."""
    def t(x, dt):
        return torch.as_tensor(x, device=device).to(dt)

    return tuple(
        BucketGroup(t(g.other_idx, torch.long), t(g.rating, dtype),
                    t(g.entity_ids, torch.long), t(g.entity_cnt, dtype))
        for g in groups)


def bucket_solve_rows(Fg, rr, cnt, lam, alpha, base_gram, acc_t,
                      gather_bf16: bool) -> torch.Tensor:
    """Gram -> guarded solve for one bucket block's gathered rows.

    Fg [NE, R, k] gathered other-factor rows; rr [NE, R] ratings in the
    factor dtype; cnt [NE] rating counts (0 for padding slots).
    """
    A, b = bucket_normal_eq(Fg, rr, alpha, acc_t, gather_bf16)
    return bucket_finish_solve(A, b, cnt, lam, alpha, base_gram)


def bucket_normal_eq(Fg, rr, alpha, acc_t, gather_bf16):
    """Per-entity normal equations over Fg's R axis (no base Gram, no
    ridge), accumulated in ``acc_t``.

    With ``gather_bf16`` the rows (and ratings, and iALS weights) arrive
    rounded to bf16, as in the reference; they are widened to ``acc_t``
    before the products, which are then exact, so only the summation order
    differs from the reference's bf16-in, f32-out einsum.
    """
    if gather_bf16:
        rr = rr.to(torch.bfloat16)
    F = Fg.to(acc_t)
    if alpha is None:
        A = torch.einsum("urk,urm->ukm", F, F)
        b = torch.einsum("urk,ur->uk", F, rr.to(acc_t))
    else:
        w = alpha * rr  # bf16 stays bf16, as in the reference
        A = torch.einsum("urk,urm->ukm", F * w.to(acc_t)[..., None], F)
        b = torch.einsum("urk,ur->uk", F, (1.0 + w).to(Fg.dtype).to(acc_t))
        # padding rows gather the zero factor row, so the +1 in the rhs
        # weight contributes nothing there
    return A, b


def bucket_finish_solve(A, b, cnt, lam, alpha, base_gram):
    """Regularize + solve fully accumulated normal equations."""
    if alpha is None:
        reg = lam * cnt + (cnt == 0)
    else:
        A = A + base_gram[None]
        reg = torch.full_like(cnt, lam)
    return guarded_batched_solve(A, b, reg.to(A.dtype))


def phase_bucketed(E: torch.Tensor, F: torch.Tensor, groups: BucketedCSR,
                   lam: float, alpha: Optional[float] = None,
                   base_gram: Optional[torch.Tensor] = None,
                   gather_bf16: bool = False) -> torch.Tensor:
    """Re-solve all entity rows of E against F, one bucket group at a time.
    Updates E in place and returns it.

    gather_bf16: gather the other factor in bfloat16 (half the gather
    bytes) with Gram sums in E's dtype, ~1e-3 relative on the normal
    equations.
    """
    F_g = F.to(torch.bfloat16) if gather_bf16 else F
    for g in groups:
        for oi, rr, eid, cnt in zip(*g):
            rows = bucket_solve_rows(F_g[oi], rr, cnt, lam, alpha,
                                     base_gram, E.dtype, gather_bf16)
            E[eid] = rows.to(E.dtype)
    return E


def als_epoch_fn(user_groups: BucketedCSR, item_groups: BucketedCSR, lam,
                 gather_bf16: bool = False):
    """state -> state, one ALS-WR epoch (user phase, then item phase
    against the NEW U). The returned state shares the input's tensors,
    which are updated in place."""
    def one(st: MFState) -> MFState:
        U = phase_bucketed(st.U, st.V, user_groups, lam,
                           gather_bf16=gather_bf16)
        V = phase_bucketed(st.V, U, item_groups, lam,
                           gather_bf16=gather_bf16)
        return st._replace(U=U, V=V)

    return one


def ials_epoch_fn(user_groups: BucketedCSR, item_groups: BucketedCSR, lam,
                  alpha, gather_bf16: bool = False):
    """iALS analog of als_epoch_fn (global base Gram per sweep side)."""
    def one(st: MFState) -> MFState:
        U = phase_bucketed(st.U, st.V, user_groups, lam, alpha,
                           st.V.T @ st.V, gather_bf16=gather_bf16)
        V = phase_bucketed(st.V, U, item_groups, lam, alpha, U.T @ U,
                           gather_bf16=gather_bf16)
        return st._replace(U=U, V=V)

    return one


def _epochs(state: MFState, n_epochs: int, epoch_fn, test_coo, train_coo):
    """n_epochs of ``epoch_fn``, each followed by the held-out RMSE (and
    the train RMSE when ``train_coo`` is given)."""
    rt, rq = [], []
    for _ in range(n_epochs):
        state = epoch_fn(state)
        rt.append(rmse_padded(state, *test_coo))
        if train_coo is not None:
            rq.append(rmse_padded(state, *train_coo))
    return state, (torch.stack(rt), torch.stack(rq) if rq else ())


def als_epochs_bucketed(state: MFState, user_groups: BucketedCSR,
                        item_groups: BucketedCSR, lam: float, n_epochs: int,
                        test_coo, train_coo=None,
                        gather_bf16: bool = False):
    """n_epochs ALS-WR sweeps + per-epoch held-out RMSE.

    test_coo/train_coo = (pu, pi, pr, n_real) as in ``rmse_padded``.
    Returns (final_state, (rmse_test [n_epochs], rmse_train [n_epochs] |
    ())).
    """
    return _epochs(state, n_epochs,
                   als_epoch_fn(user_groups, item_groups, lam, gather_bf16),
                   test_coo, train_coo)


def ials_epochs_bucketed(state: MFState, user_groups: BucketedCSR,
                         item_groups: BucketedCSR, lam: float, alpha: float,
                         n_epochs: int, test_coo, train_coo=None,
                         gather_bf16: bool = False):
    """n_epochs iALS sweeps + per-epoch held-out RMSE."""
    return _epochs(state, n_epochs,
                   ials_epoch_fn(user_groups, item_groups, lam, alpha,
                                 gather_bf16),
                   test_coo, train_coo)

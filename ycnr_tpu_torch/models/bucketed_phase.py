"""Bucketed solve phases for ALS-WR and iALS (counterpart of
``ycnr_tpu/models/bucketed_phase.py``).

The layout is ``ops/bucketed.build_bucketed``'s, unchanged: every entity
of a group owns exactly R rating slots, so its Gram matrix is one batched
product over the R axis. A phase walks each group block by block: gather
the other factor's rows (the row-gather kernel on CUDA), build the normal
equations, run the guarded batched solve (K1 on CUDA) and write the rows
back. For the main path, bf16 ALS-WR, the gather, the normal equations and
the ridge are one fused gather -> Gram kernel whose A goes straight to K1.

The JAX package's scans become Python loops. A phase writes its solved rows
into ``E`` in place: blocks of one phase read only the other factor, so the
order of the writes does not matter, and padding slots all write the
trash row with rows that solve to exactly 0.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ycnr_tpu_torch import resolve_device
from ycnr_tpu_torch.models.base import MFState, rmse_padded
from ycnr_tpu_torch.ops.fused_gram import MAX_W, fused_gram
from ycnr_tpu_torch.ops.gram import guarded_batched_solve
from ycnr_tpu_torch.ops.row_gather import row_gather
from ycnr_tpu_torch.ops.spd_solve import spd_solve


class DeviceBucketGroup(NamedTuple):
    """One bucket group as tensors (``device_bucketed``)."""

    other_idx: torch.Tensor  # [NB, NE_b, R] int64
    rating: torch.Tensor  # [NB, NE_b, R]; bf16 for the fused branch
    entity_ids: torch.Tensor  # [NB, NE_b] int64
    entity_cnt: torch.Tensor  # [NB, NE_b]


DeviceBucketedCSR = Tuple[DeviceBucketGroup, ...]


def device_bucketed(groups, dtype=torch.float32, device=None,
                    rating_dtype: Optional[torch.dtype] = None
                    ) -> DeviceBucketedCSR:
    """Move a host ``build_bucketed`` layout into tensors on ``device``
    (None: the card, ``resolve_device``; indices as int64, counts in
    ``dtype``, ratings in ``rating_dtype``, by default ``dtype``). The fused branch of ``phase_bucketed`` reads
    bf16 ratings as they are: ``rating_dtype=torch.bfloat16`` rounds them
    once, to the values the JAX package rounds in every phase
    (``uses_fused`` says when a layout needs them)."""
    device = resolve_device(device, "device_bucketed()")

    def t(x, dt):
        return torch.as_tensor(x, device=device).to(dt)

    return tuple(
        DeviceBucketGroup(
            t(g.other_idx, torch.long), t(g.rating, rating_dtype or dtype),
            t(g.entity_ids, torch.long), t(g.entity_cnt, dtype))
        for g in groups)


def uses_fused(device, dtype, alpha, gather_bf16: bool, width: int) -> bool:
    """Whether ``phase_bucketed`` runs the fused branch for factors of
    ``dtype`` and rank ``width`` on ``device``: ALS-WR (``alpha`` None)
    with bf16 gathers into f32 factors on CUDA, at a width the fused
    gather -> Gram kernel takes (``fused_gram.MAX_W``). Its layouts then
    hold bf16 ratings; every other case reads them in the factors' dtype
    and runs the row gather, the einsums and K1, as the JAX package's
    gather -> Gram is an XLA einsum at every width."""
    return (torch.device(device).type == "cuda" and alpha is None
            and gather_bf16 and dtype == torch.float32 and width <= MAX_W)


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


def bucket_fused_rows(F_g, oi, rr16, cnt, lam) -> torch.Tensor:
    """The main path's block: bf16 ALS-WR normal equations with the ridge
    ``lam * cnt + (cnt == 0)`` from the fused gather -> Gram, then the
    solve. F_g the bf16 other factor, oi [NE, R], rr16 [NE, R] bf16
    ratings, cnt [NE] f32. ``fused_gram``'s A already holds the ridge and
    is symmetric, so no ``guarded_batched_solve`` pass runs; on the CPU
    both steps are their plain versions, and the result equals
    ``bucket_solve_rows`` with bf16 gathers bit for bit."""
    A, b = fused_gram(F_g, oi, rr16, reg=lam * cnt + (cnt == 0))
    return spd_solve(A, b)


def phase_bucketed(E: torch.Tensor, F: torch.Tensor,
                   groups: DeviceBucketedCSR, lam: float,
                   alpha: Optional[float] = None,
                   base_gram: Optional[torch.Tensor] = None,
                   gather_bf16: bool = False) -> torch.Tensor:
    """Re-solve all entity rows of E against F, one bucket group at a time.
    Updates E in place and returns it.

    gather_bf16: gather the other factor in bfloat16 (half the gather
    bytes) with Gram sums in E's dtype, ~1e-3 relative on the normal
    equations.

    On CUDA, ALS-WR with bf16 gathers into an f32 E of rank <= 128 (the
    main path) runs ``bucket_fused_rows``: the fused gather -> Gram kernel
    with the ridge in its epilogue, then K1; its layouts hold bf16 ratings
    (``uses_fused``).
    Every other case gathers with the row-gather kernel
    (``ops/row_gather.py``) and runs ``bucket_normal_eq`` and
    ``guarded_batched_solve``, with ratings in E's dtype. On the CPU every
    kernel is its plain version, which is this function's plain path.
    """
    F_g = F.to(torch.bfloat16) if gather_bf16 else F
    fused = uses_fused(E.device, E.dtype, alpha, gather_bf16, E.shape[1])
    want = torch.bfloat16 if fused else E.dtype
    for g in groups:
        if g.rating.dtype != want:
            raise ValueError(
                f"phase_bucketed reads {want} ratings here, the layout holds "
                f"{g.rating.dtype}: build it with device_bucketed(..., "
                f"rating_dtype={want})")
        for j in range(g.other_idx.shape[0]):
            oi, rr, cnt = g.other_idx[j], g.rating[j], g.entity_cnt[j]
            if fused:
                rows = bucket_fused_rows(F_g, oi, rr, cnt.to(E.dtype), lam)
            else:
                rows = bucket_solve_rows(row_gather(F_g, oi), rr, cnt, lam,
                                         alpha, base_gram, E.dtype,
                                         gather_bf16)
            E[g.entity_ids[j]] = rows.to(E.dtype)
    return E


def als_epoch_fn(user_groups: DeviceBucketedCSR,
                 item_groups: DeviceBucketedCSR, lam,
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


def ials_epoch_fn(user_groups: DeviceBucketedCSR,
                 item_groups: DeviceBucketedCSR, lam,
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


def als_epochs_bucketed(state: MFState, user_groups: DeviceBucketedCSR,
                        item_groups: DeviceBucketedCSR, lam: float,
                        n_epochs: int,
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


def ials_epochs_bucketed(state: MFState, user_groups: DeviceBucketedCSR,
                         item_groups: DeviceBucketedCSR, lam: float,
                         alpha: float,
                         n_epochs: int, test_coo, train_coo=None,
                         gather_bf16: bool = False):
    """n_epochs iALS sweeps + per-epoch held-out RMSE."""
    return _epochs(state, n_epochs,
                   ials_epoch_fn(user_groups, item_groups, lam, alpha,
                                 gather_bf16),
                   test_coo, train_coo)

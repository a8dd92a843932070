"""Gather -> Gram -> guarded batched solve on the blocked layout.

Counterpart of ``ycnr_tpu/ops/gram.py``. One block of a ``BlockedCSR``
(``ops/layout.py``) is solved as:

    gather rows of the other factor        ``row_gather`` (kernel on CUDA)
    chunk Grams and right-hand sides       two einsums  [C_B, L, k]
    chunk -> entity-slot sums              sorted-segment sum, in order
    guarded batched solve                  K1 on CUDA

Padding needs no masks: padding slots gather the all-zero trash row, so
they add exactly 0, and padding entity slots solve the guarded identity
system to exactly 0, which keeps the trash row zero.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ycnr_tpu_torch.ops.row_gather import row_gather
from ycnr_tpu_torch.ops.spd_solve import spd_solve

guarded_solves = 0  # guarded_batched_solve calls since the last reset


class BlockData(NamedTuple):
    """One block of a device ``BlockedCSR`` (``models.base.device_layout``)."""

    other_idx: torch.Tensor  # [C_B, L] int
    rating: torch.Tensor  # [C_B, L] float
    chunk_seg: torch.Tensor  # [C_B] int, sorted; n_slots = padding
    entity_ids: torch.Tensor  # [U_B] int
    entity_cnt: torch.Tensor  # [U_B] float


def chunk_gram_rhs(F_gathered: torch.Tensor, rating: torch.Tensor,
                   weight: Optional[torch.Tensor] = None,
                   rhs_weight: Optional[torch.Tensor] = None,
                   acc_dtype=None):
    """Per-chunk Gram matrices and right-hand sides.

    F_gathered [C_B, L, k]; weight: optional per-rating Gram weight (iALS:
    alpha*r); rhs_weight: optional RHS weight (iALS: 1 + alpha*r), else
    the rating. Weights are rounded to the rows' dtype and the weighted
    rows formed there, as in the reference; the einsums then run in
    ``acc_dtype`` (default: the rows' dtype) on rows widened to it, which
    is exact for bf16 rows. Returns (G [C_B, k, k], b [C_B, k]).
    """
    acc = acc_dtype or F_gathered.dtype
    lhs = F_gathered if weight is None else (
        F_gathered * weight.to(F_gathered.dtype)[..., None])
    F = F_gathered.to(acc)
    G = torch.einsum("clk,clm->ckm", lhs.to(acc), F)
    rv = rating if rhs_weight is None else rhs_weight
    b = torch.einsum("clk,cl->ck", F, rv.to(F_gathered.dtype).to(acc))
    return G, b


def segment_reduce_block(G: torch.Tensor, b: torch.Tensor,
                         chunk_seg: torch.Tensor, n_slots: int):
    """Sum chunk Grams/RHS into per-entity slots.

    chunk_seg is sorted within a block (the builder packs sequentially;
    padding chunks carry n_slots and are dropped). Each slot's chunks are
    summed one after another in chunk order, with no atomics, so the
    result is the same on every run.
    """
    bounds = torch.arange(n_slots + 2, dtype=chunk_seg.dtype,
                          device=chunk_seg.device)
    offsets = torch.searchsorted(chunk_seg.contiguous(), bounds)
    A = torch.segment_reduce(G, "sum", offsets=offsets, axis=0,
                             unsafe=True)[:n_slots]
    r = torch.segment_reduce(b, "sum", offsets=offsets, axis=0,
                             unsafe=True)[:n_slots]
    return A, r


def guarded_batched_solve(A: torch.Tensor, b: torch.Tensor,
                          reg: torch.Tensor) -> torch.Tensor:
    """Solve (A + reg * I) x = b per batch element.

    reg: [B] per-entity ridge; callers pass lam*n_e + (n_e==0) so empty
    slots solve I x = 0 -> exactly 0. The ridge is added before the
    symmetrization, in the reference's order. On the CPU the solve is the
    plain Cholesky; on CUDA it is K1 (``ops/spd_solve.py``), which raises
    for what it does not take (float64, n > 256).
    """
    global guarded_solves
    guarded_solves += 1
    k = A.shape[-1]
    eye = torch.eye(k, dtype=A.dtype, device=A.device)
    A = A + reg[:, None, None] * eye
    A = 0.5 * (A + A.transpose(-1, -2))  # enforce symmetry
    return spd_solve(A, b)


def solve_block(F_pad: torch.Tensor, blk: BlockData, lam: float,
                gram_weight_alpha: Optional[float] = None,
                base_gram: Optional[torch.Tensor] = None,
                base_reg: float = 0.0, gather_bf16: bool = False):
    """Solve one block's entities against the (padded) other factor.

    Explicit ALS-WR: ridge lam * n_e, no base Gram. Implicit iALS:
    gram_weight_alpha = alpha (w = alpha*r), base_gram = F^T F, constant
    ridge base_reg = lam, RHS weight 1 + alpha*r. gather_bf16 gathers F in
    bfloat16 and accumulates in F_pad's dtype.
    Returns (entity_ids, new_rows [U_B, k]).
    """
    acc_dtype = F_pad.dtype
    F_src = F_pad.to(torch.bfloat16) if gather_bf16 else F_pad
    Fg = row_gather(F_src, blk.other_idx)  # [C_B, L, k]
    n_slots = blk.entity_ids.shape[0]
    cnt = blk.entity_cnt
    if gram_weight_alpha is None:
        G, b = chunk_gram_rhs(Fg, blk.rating, acc_dtype=acc_dtype)
        A, rhs = segment_reduce_block(G, b, blk.chunk_seg, n_slots)
        reg = lam * cnt + (cnt == 0)
    else:
        w = gram_weight_alpha * blk.rating
        G, b = chunk_gram_rhs(Fg, blk.rating, weight=w, rhs_weight=1.0 + w,
                              acc_dtype=acc_dtype)
        A, rhs = segment_reduce_block(G, b, blk.chunk_seg, n_slots)
        A = A + base_gram[None]
        reg = torch.full_like(cnt, base_reg)
    # padding slots: explicit solves I x = 0, implicit (G + lam I) x = 0,
    # both exactly 0, keeping the trash row zero
    rows = guarded_batched_solve(A, rhs, reg.to(A.dtype))
    return blk.entity_ids, rows

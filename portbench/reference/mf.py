"""Plain matrix-factorization reference: per-entity normal equations from
the COO itself, in float64, in blocks of entities so that it fits.

Nothing here imports the program: lists, ridges, base Grams and solves
are worked out again from the benchmark's own ratings and factors.
``round_to`` rounds the rows that the configuration gathers to the
precision it states (``bfloat16`` on the main path), or to a lower one
for the control (``float8_e4m3fn``; ``tf32`` for a float32 product).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# a float32 product on the card may run in TF32 unless these are off; the
# reference's own float64 products are unaffected, the emulated TF32 of the
# control is explicit (``round_to``)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` rounded to ``precision`` and widened to float64."""
    if precision == "float64":
        return x.double()
    if precision == "float32":
        return x.float().double()
    if precision == "tf32":  # 10 stored mantissa bits, round to nearest
        bits = x.float().contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF
        return bits.view(torch.float32).double()
    return x.to(getattr(torch, precision)).double()


class Lists(NamedTuple):
    """Every entity's ratings, grouped by entity (stable order)."""

    other: torch.Tensor  # [nnz] int64, grouped by entity
    rating: torch.Tensor  # [nnz] float64
    starts: torch.Tensor  # [n] int64
    counts: torch.Tensor  # [n] int64
    n_other: int


def entity_lists(entity, other, rating, n_entities: int,
                 n_other: int) -> Lists:
    order = torch.sort(entity, stable=True).indices
    counts = torch.bincount(entity, minlength=n_entities)
    starts = torch.cumsum(counts, 0) - counts
    return Lists(other[order].long(), rating[order].double(), starts,
                 counts, n_other)


def _blocks(counts: torch.Tensor, budget: int, max_batch: int):
    """Entities with ratings, by count descending, cut into blocks of at
    most ``budget`` padded slots whose counts stay within a factor of two
    (padding at most doubles a block)."""
    c, ents = torch.sort(counts, descending=True, stable=True)
    n_active = int((c > 0).sum())
    c = c[:n_active].tolist()
    ents = ents[:n_active]
    lo = 0
    while lo < n_active:
        R = c[lo]
        hi = lo + 1
        cap = min(max_batch, max(1, budget // R))
        while hi < n_active and hi - lo < cap and 2 * c[hi] >= R:
            hi += 1
        yield ents[lo:hi], R
        lo = hi


def solve_side(F: torch.Tensor, lists: Lists, lam: float, alpha,
               gather: str, base_gram=None, budget: int = 1 << 22,
               max_batch: int = 1 << 15) -> torch.Tensor:
    """New rows ``[n + 1, k]`` (float64) for every entity of ``lists``
    against the other side's table ``F`` (``[n_other + 1, k]``, its last
    row zero). ALS-WR (``alpha`` None): ``(G^T G + lam n_e I) x = G^T r``.
    iALS: ``(F^T F + G^T diag(alpha r) G + lam I) x = G^T (1 + alpha r)``
    with ``base_gram`` = F^T F. ``G`` holds the entity's rows of ``F``
    rounded to ``gather``. Entities without ratings keep a zero row."""
    n = lists.counts.numel()
    k = F.shape[1]
    dev = F.device
    Fg = round_to(F, gather)
    out = torch.zeros(n + 1, k, dtype=torch.float64, device=dev)
    eye = torch.eye(k, dtype=torch.float64, device=dev)
    total = lists.other.numel()
    for ents, R in _blocks(lists.counts, budget, max_batch):
        cnt = lists.counts[ents]
        slot = torch.arange(R, device=dev)
        valid = slot[None, :] < cnt[:, None]
        pos = (lists.starts[ents][:, None] + slot[None, :]).clamp_(
            max=total - 1)
        idx = torch.where(valid, lists.other[pos], lists.n_other)
        r = torch.where(valid, lists.rating[pos], 0.0)
        G = Fg[idx]  # [b, R, k]; padding gathers the zero row
        if alpha is None:
            A = G.transpose(1, 2) @ G
            A += (lam * cnt.double())[:, None, None] * eye
            b = (G.transpose(1, 2) @ r[..., None])[..., 0]
        else:
            w = alpha * r
            A = (G * w[..., None]).transpose(1, 2) @ G
            A += base_gram + lam * eye
            b = (G.transpose(1, 2) @ (1.0 + w)[..., None])[..., 0]
        L = torch.linalg.cholesky(A)
        out[ents] = torch.cholesky_solve(b[..., None], L)[..., 0]
    return out


def epoch(V: torch.Tensor, lists_u: Lists, lists_i: Lists, lam: float,
          alpha, gather: str):
    """One epoch from the item table ``V``: the user half-step against
    ``V``, then the item half-step against the new ``U``. Returns
    ``(U, V)`` in float64."""
    Vd = V.double()
    base = None if alpha is None else Vd.T @ Vd
    U = solve_side(Vd, lists_u, lam, alpha, gather, base)
    base = None if alpha is None else U.T @ U
    return U, solve_side(U, lists_i, lam, alpha, gather, base)


def zero_cold(F: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """``F`` (float64) with the rows of entities without ratings, and the
    trash row, set to zero."""
    F = F.double().clone()
    F[:-1][counts == 0] = 0.0
    F[-1] = 0.0
    return F


def rmse(U, V, u, i, r, chunk: int = 1 << 22) -> float:
    """Held-out RMSE of ``U V^T`` over the COO ``(u, i, r)``, float64."""
    total = torch.zeros((), dtype=torch.float64, device=U.device)
    for s in range(0, u.numel(), chunk):
        uu, ii = u[s:s + chunk], i[s:s + chunk]
        err = r[s:s + chunk].double() - (U[uu].double()
                                          * V[ii].double()).sum(1)
        total += (err * err).sum()
    return float(torch.sqrt(total / max(u.numel(), 1)))


def row_gap(P: torch.Tensor, R: torch.Tensor) -> float:
    """The worst row's distance between a table ``P`` and the reference
    ``R``, over the larger of that row's reference norm and the median
    norm of the reference's nonzero rows (cold and trash rows are zero in
    both, and a near-zero row must not blow the ratio up)."""
    d = (P.double() - R.double()).norm(dim=1)
    ref = R.double().norm(dim=1)
    live = ref[ref > 0]
    floor = float(live.median()) if live.numel() else 1.0
    return float((d / ref.clamp(min=floor)).max())

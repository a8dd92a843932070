"""Plain top-N reference: every item scored in float64, the user's rated
items masked, and served lists judged against it.

A served list is judged item by item: each served item must exist, be
unrated by that user and appear once, the list must be as long as the
user has unrated items (up to n), and each served item's reference score
may lie below the reference's n-th best by at most a gap. The gap is
taken over the user's largest absolute reference score, so that one
number reads alike for every user.
"""

from __future__ import annotations

import torch

from portbench.reference.mf import round_to


def rated_index(train_u, train_i):
    """The training pairs grouped by user: ``(items, starts, counts)``."""
    order = torch.sort(train_u, stable=True).indices
    counts = torch.bincount(train_u)
    return train_i[order].long(), torch.cumsum(counts, 0) - counts, counts


def _masked_scores(U, V, users, index, precision: str):
    """``[b, n_items]`` float64 scores of ``users`` with rated items at
    -inf, from ``U``, ``V`` (trash rows excluded) rounded to
    ``precision``."""
    items, starts, counts = index
    users = users.long()
    n_items = V.shape[0] - 1
    S = round_to(U[users], precision) @ round_to(V[:n_items], precision).T
    if precision not in ("float64", "float32"):
        S = S.float().double()  # a lower-precision product stores f32
    c = torch.zeros_like(users)
    ok = users < counts.numel()
    c[ok] = counts[users[ok]]
    row = torch.repeat_interleave(torch.arange(users.numel(),
                                               device=U.device), c)
    first = torch.zeros_like(users)
    first[ok] = starts[users[ok]]
    pos = torch.arange(int(c.sum()), device=U.device) - torch.repeat_interleave(
        torch.cumsum(c, 0) - c, c) + torch.repeat_interleave(first, c)
    S[row, items[pos]] = float("-inf")
    return S


def check_lists(U, V, users, lists, n: int, index, block: int = 2048) -> dict:
    """Judge served lists. ``users`` [m] int64 and ``lists`` [m, n] int64
    (-1 where the program served nothing) on U's device. Returns the
    widest relative gap and the counts of each kind of fault."""
    n_items = V.shape[0] - 1
    out = {"gap": 0.0, "rated": 0, "unknown": 0, "dup": 0, "short": 0,
           "lists": int(users.numel())}
    for s in range(0, users.numel(), block):
        us, L = users[s:s + block], lists[s:s + block]
        S = _masked_scores(U, V, us, index, "float64")
        finite = S > float("-inf")
        n_unrated = finite.sum(1)
        kth = torch.topk(S, n, dim=1).values[:, n - 1]
        scale = torch.where(finite, S.abs(), 0.0).amax(1).clamp(
            min=torch.finfo(torch.float64).tiny)
        served = L >= 0
        known = served & (L < n_items)
        out["unknown"] += int((served & ~known).sum())
        s_served = torch.gather(S, 1, torch.where(known, L, 0))
        rated = known & (s_served == float("-inf"))
        out["rated"] += int(rated.sum())
        good = known & ~rated
        srt = torch.sort(torch.where(served, L, -1 - torch.arange(
            n, device=L.device)[None]), dim=1).values
        out["dup"] += int((srt[:, 1:] == srt[:, :-1]).sum())
        out["short"] += int((served.sum(1) < n_unrated.clamp(max=n)).sum())
        gap = torch.where(good, (kth[:, None] - s_served) / scale[:, None],
                          0.0)
        # a user with fewer than n unrated items has kth = -inf: every
        # unrated item is then a right answer
        gap = torch.where(torch.isfinite(gap), gap, 0.0)
        out["gap"] = max(out["gap"], float(gap.max()) if gap.numel() else 0.0)
    return out


def top_lists(U, V, users, n: int, index, precision: str,
              block: int = 2048) -> torch.Tensor:
    """The reference's own top-n lists [m, n] (-1 past the user's unrated
    items) with the products in ``precision``: the control puts these in
    the program's place."""
    out = []
    for s in range(0, users.numel(), block):
        S = _masked_scores(U, V, users[s:s + block], index, precision)
        v, i = torch.topk(S, n, dim=1)
        out.append(torch.where(v > float("-inf"), i, -1))
    return torch.cat(out) if out else torch.empty(0, n, dtype=torch.long)

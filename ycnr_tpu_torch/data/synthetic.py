"""Synthetic ratings generator (the port's copy of
``ycnr_tpu/data/synthetic.py``: the same draws from the same seed).

The reference imports MovieLens into PostgreSQL (SURVEY.md C7, call stack
3.1). This environment has no network (SURVEY.md §7), so the primary dataset
source is a controllable synthetic generator: a planted low-rank model with
power-law entity popularity, which reproduces the padding-waste profile of
real MovieLens/Netflix data (SURVEY.md §7 hard parts).
"""

from __future__ import annotations

import numpy as np


def synthetic_ratings(
    n_users: int,
    n_items: int,
    n_ratings: int,
    true_rank: int = 8,
    noise: float = 0.25,
    seed: int = 0,
    rating_levels: bool = True,
    power_law: float = 1.0,
):
    """Sample (user, item, rating) COO from a planted rank-`true_rank` model.

    Popularity of users and items follows an approximate Zipf distribution
    with exponent ``power_law`` (0 disables). Duplicate (u, i) pairs are
    removed, so the returned nnz may be slightly below ``n_ratings``.
    """
    rng = np.random.default_rng(seed)

    def zipf_cdf(n: int) -> np.ndarray:
        if power_law <= 0:
            p = np.full(n, 1.0 / n)
        else:
            p = 1.0 / np.arange(1, n + 1) ** power_law
            rng.shuffle(p)
        c = np.cumsum(p)
        return c / c[-1]

    # inverse-CDF sampling (cumsum once + searchsorted per draw) is ~4x
    # faster than Generator.choice(p=...) at the 10^7-sample scale the
    # ML-20M/Netflix benches need
    cu = zipf_cdf(n_users)
    ci = zipf_cdf(n_items)
    # sample in rounds, deduping (u, i) cumulatively, until the target count
    # is reached (zipf-concentrated popularity collides heavily, so a single
    # oversampled draw can fall far short). `seen` stays sorted; each round
    # uniques only the NEW draws, drops members already seen, and merges via
    # one vectorized sorted insert — never re-sorting the accumulated set.
    seen = np.zeros(0, np.int64)
    oversample = 1.6
    for _ in range(12):
        short = n_ratings - len(seen)
        if short <= 0:
            break
        m = int(short * oversample) + 16
        uu = np.searchsorted(cu, rng.random(m)).astype(np.int64)
        ii = np.searchsorted(ci, rng.random(m)).astype(np.int64)
        new = np.unique(uu * n_items + ii)
        if len(seen):
            pos = np.searchsorted(seen, new)
            hit = (pos < len(seen)) & (seen[np.minimum(pos, len(seen) - 1)]
                                       == new)
            # dropping already-seen keys does not move the survivors'
            # insertion points, so pos can be reused instead of re-searching
            pos, new = pos[~hit], new[~hit]
            seen = np.insert(seen, pos, new)
        else:
            seen = new
        # adapt the oversample factor to the measured collision yield (intra-
        # draw AND vs prior rounds) so the loop converges in ~3 rounds instead
        # of the worst-case 12 — each round's draws are expensive on a 1-core
        # host at 10^7 scale
        oversample = min(1.25 / max(len(new) / m, 0.05), 24.0)
        if len(seen) >= 0.98 * n_users * n_items:
            break  # grid nearly full; stop resampling
    if len(seen) > n_ratings:
        seen = seen[rng.choice(len(seen), n_ratings, replace=False)]
    u = (seen // n_items).astype(np.int64)
    i = (seen % n_items).astype(np.int64)

    P = rng.normal(0, 1.0 / np.sqrt(true_rank),
                   (n_users, true_rank)).astype(np.float32)
    Q = rng.normal(0, 1.0 / np.sqrt(true_rank),
                   (n_items, true_rank)).astype(np.float32)
    # score in f32 chunks: materializing P[u]/Q[i] whole would allocate
    # O(nnz * rank) fresh pages, which dominates wall time on ballooned VMs
    r = np.empty(len(u), np.float32)
    for s in range(0, len(u), 4_000_000):
        e = min(s + 4_000_000, len(u))
        raw = np.einsum("nk,nk->n", P[u[s:e]], Q[i[s:e]])
        raw += noise * rng.standard_normal(e - s, dtype=np.float32)
        # squash onto a star-like scale centered at 3. tanh in (-1, 1)
        # bounds this to (1.5, 4.5) — a COMPRESSED version of MovieLens's
        # 0.5..5.0 range (extreme ratings never occur). Kept as-is: the
        # perf benches are value-independent, parity tests compare
        # implementations on the same draw, and widening the scale would
        # invalidate every pinned golden metric for cosmetic realism.
        r[s:e] = 3.0 + 1.5 * np.tanh(raw)
    if rating_levels:
        r = np.clip(np.round(r * 2) / 2, 0.5, 5.0)
    return u.astype(np.int32), i.astype(np.int32), r.astype(np.float32)


# Published ML-20M rating-value marginals (GroupLens dataset summary),
# recalled from memory to ~0.5% absolute — the closest achievable stand-in
# while the environment has no network (SURVEY.md §0); replace with the
# measured histogram the moment a real ratings.csv is available. Mean 3.53;
# whole-star spikes (3.0/4.0/5.0 carry 64%) are the signature real-data
# structure the planted tanh squash cannot produce.
ML20M_RATING_HIST = {
    0.5: 0.0120, 1.0: 0.0340, 1.5: 0.0140, 2.0: 0.0716, 2.5: 0.0442,
    3.0: 0.2146, 3.5: 0.1100, 4.0: 0.2780, 4.5: 0.0767, 5.0: 0.1449,
}


def synthetic_ratings_calibrated(
    n_users: int,
    n_items: int,
    n_ratings: int,
    true_rank: int = 8,
    noise: float = 0.25,
    seed: int = 0,
    min_degree: int = 20,
    item_exponent: float = 0.9,
    rating_hist: dict | None = None,
):
    """Planted-model ratings calibrated to published ML-20M marginals.

    Differences vs ``synthetic_ratings`` (VERDICT round 2 item 9):

    - **Rating histogram**: raw planted scores are QUANTILE-MAPPED onto
      ``rating_hist`` (default ``ML20M_RATING_HIST``), so the value
      marginal matches the published ML-20M distribution exactly (up to
      rounding) while the planted low-rank ORDER structure — what the
      trainers actually learn — is preserved. The base generator's tanh
      squash compresses to (1.5, 4.5) and never emits the whole-star
      spikes that dominate real data.
    - **User degrees**: drawn from a Pareto tail with the dataset's
      ``min_degree`` floor (ML-20M filters users to >= 20 ratings), scaled
      to hit ``n_ratings`` — so user degree is exact-by-construction
      (modulo per-user dedup), not a Zipf-collision byproduct.
    - **Item popularity**: inverse-CDF Zipf with ``item_exponent`` (~0.9
      fits the published ML-20M item-degree tail better than 1.0).

    Returns (u, i, r) COO like the base generator. Deterministic in
    ``seed``. Duplicate (u, i) pairs are redrawn once, then dropped, so a
    heavy user's realized degree can fall slightly below target.
    """
    rng = np.random.default_rng(seed)
    hist = ML20M_RATING_HIST if rating_hist is None else rating_hist
    mean_deg = n_ratings / n_users
    xm = min(min_degree, max(1, int(0.6 * mean_deg)))
    # Pareto(xm, alpha) mean = alpha*xm/(alpha-1) -> alpha for the target
    # mean; alpha <= 1 (mean <= xm) degenerates to the constant floor
    alpha = mean_deg / (mean_deg - xm) if mean_deg > xm * 1.01 else 50.0
    deg = xm * (1.0 + rng.pareto(alpha, n_users))
    deg = np.minimum(deg, n_items)  # can't rate more distinct items
    # scale to the exact total (largest-remainder rounding), keep the floor
    deg *= n_ratings / deg.sum()
    deg = np.maximum(deg, min(xm, n_items)).astype(np.int64)
    short = n_ratings - int(deg.sum())
    if short > 0:  # spread the remainder over random users with headroom
        room = np.flatnonzero(deg < n_items)
        add = rng.choice(room, min(short, len(room)), replace=False)
        deg[add] += 1
    elif short < 0:
        room = np.flatnonzero(deg > xm)
        cut = rng.choice(room, min(-short, len(room)), replace=False)
        deg[cut] -= 1
    u = np.repeat(np.arange(n_users, dtype=np.int64), deg)

    if item_exponent <= 0:
        p = np.full(n_items, 1.0 / n_items)
    else:
        p = 1.0 / np.arange(1, n_items + 1, dtype=np.float64) ** item_exponent
        rng.shuffle(p)
    ci = np.cumsum(p)
    ci /= ci[-1]
    i = np.searchsorted(ci, rng.random(len(u))).astype(np.int64)
    # per-user dedup: redraw collided rows (hot user x hot item pairs
    # collide persistently on dense grids), then drop what remains
    for _ in range(8):
        key = u * n_items + i
        srt = np.argsort(key, kind="stable")
        dup_s = np.zeros(len(key), bool)
        dup_s[1:] = key[srt][1:] == key[srt][:-1]
        dup = np.zeros(len(key), bool)
        dup[srt] = dup_s
        if not dup.any():
            break
        i[dup] = np.searchsorted(ci, rng.random(int(dup.sum())))
    keep = ~dup
    u, i = u[keep], i[keep]

    P = rng.normal(0, 1.0 / np.sqrt(true_rank),
                   (n_users, true_rank)).astype(np.float32)
    Q = rng.normal(0, 1.0 / np.sqrt(true_rank),
                   (n_items, true_rank)).astype(np.float32)
    raw = np.empty(len(u), np.float32)
    for s in range(0, len(u), 4_000_000):
        e = min(s + 4_000_000, len(u))
        raw[s:e] = np.einsum("nk,nk->n", P[u[s:e]], Q[i[s:e]])
        raw[s:e] += noise * rng.standard_normal(e - s, dtype=np.float32)
    # quantile map: rank the raw scores, hand the lowest-ranked block to
    # the lowest star level with the published proportion, and so on —
    # the marginal becomes the target histogram exactly (largest-remainder
    # rounding), the planted ordering survives untouched
    levels = np.array(sorted(hist), np.float32)
    props = np.array([hist[float(v)] for v in levels], np.float64)
    props /= props.sum()
    n = len(raw)
    counts = np.floor(props * n).astype(np.int64)
    rem = n - counts.sum()
    if rem > 0:  # largest fractional remainders absorb the rounding gap
        frac = props * n - np.floor(props * n)
        counts[np.argsort(-frac)[:rem]] += 1
    r = np.empty(n, np.float32)
    r[np.argsort(raw, kind="stable")] = np.repeat(levels, counts)
    return u.astype(np.int32), i.astype(np.int32), r

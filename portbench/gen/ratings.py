"""Synthetic ratings and factors made on the device from a seed.

The algorithm is the one of ``ycnr_tpu_torch/data/synthetic.py``
(``synthetic_ratings``), rewritten in PyTorch so that it runs on the card
in a few large calls instead of a minute of single-core NumPy: Zipf
popularity on both sides (each side's weights ``1 / rank ** power_law`` in
a random order), (user, item) pairs drawn by inverse CDF in rounds and
deduplicated until there are enough, then cut to the exact count; a
planted rank-``true_rank`` model ``3 + 1.5 tanh(p_u . q_i + noise)``
rounded to half-star levels. The random holdout is
``data/split.train_test_split``'s (a permutation, the first share held
out).

Every seed gets the same set of sizes in another order: the (user, item)
pairs and the holdout are drawn once from a fixed structure stream, and
the seed relabels users and items by random permutations and draws the
planted factors, the noise and the order of the ratings. So every seed's
layouts hold the same degrees, padding and blocks, and a run's time does
not move with the seed, while its ids, ratings and factors do.

Draws come from ``torch.Generator``s on ``device``: the same seed on the
same kind of device gives the same bits. The streams of the card and of
the CPU differ, so a CPU run is a test of the algorithm, not of the
card's data.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Ratings(NamedTuple):
    """A split ratings set on one device (int64 ids, float32 ratings) and
    the planted factors it was scored from."""

    train_u: torch.Tensor
    train_i: torch.Tensor
    train_r: torch.Tensor
    test_u: torch.Tensor
    test_i: torch.Tensor
    test_r: torch.Tensor
    P: torch.Tensor  # [n_users, true_rank] planted user factors
    Q: torch.Tensor  # [n_items, true_rank] planted item factors
    n_users: int
    n_items: int


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for ``seed``; ``stream`` separates the
    draws of independent consumers of one seed (data, start factors)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def _zipf_cdf(n: int, power_law: float, g, device) -> torch.Tensor:
    if power_law <= 0:
        p = torch.full((n,), 1.0 / n, dtype=torch.float64, device=device)
    else:
        p = 1.0 / torch.arange(1, n + 1, dtype=torch.float64,
                               device=device) ** power_law
        p = p[torch.randperm(n, generator=g, device=device)]
    c = torch.cumsum(p, 0)
    return c / c[-1]


def draw_pairs(n_users: int, n_items: int, n_ratings: int,
               power_law: float, g, device) -> torch.Tensor:
    """``n_ratings`` distinct keys ``u * n_items + i``, in a random
    order."""
    if n_ratings > n_users * n_items:
        raise ValueError("more ratings than (user, item) pairs")
    cu = _zipf_cdf(n_users, power_law, g, device)
    ci = _zipf_cdf(n_items, power_law, g, device)
    seen = torch.empty(0, dtype=torch.int64, device=device)
    oversample = 1.6
    for _ in range(64):
        short = n_ratings - seen.numel()
        if short <= 0:
            break
        m = int(short * oversample) + 16
        uu = torch.searchsorted(cu, torch.rand(m, generator=g, device=device,
                                               dtype=torch.float64))
        ii = torch.searchsorted(ci, torch.rand(m, generator=g, device=device,
                                               dtype=torch.float64))
        new = uu.clamp_(max=n_users - 1) * n_items + ii.clamp_(max=n_items - 1)
        merged = torch.unique(torch.cat([seen, new]))
        # the same adaptive oversampling as the NumPy generator: the
        # collision yield of this round sets the next round's draw count
        gained = merged.numel() - seen.numel()
        seen = merged
        oversample = min(1.25 / max(gained / m, 0.05), 24.0)
    if seen.numel() < n_ratings:
        raise ValueError(f"drew only {seen.numel()} distinct pairs of "
                         f"{n_ratings}")
    keep = torch.randperm(seen.numel(), generator=g, device=device)
    return seen[keep[:n_ratings]]


def planted_ratings(u, i, P, Q, noise: float, g,
                    chunk: int = 1 << 22) -> torch.Tensor:
    """``clip(round(2 (3 + 1.5 tanh(p_u . q_i + noise e))) / 2, 0.5, 5)``
    in float32, scored in chunks."""
    r = torch.empty(u.numel(), dtype=torch.float32, device=u.device)
    for s in range(0, u.numel(), chunk):
        e = min(s + chunk, u.numel())
        raw = (P[u[s:e]] * Q[i[s:e]]).sum(1)
        raw += noise * torch.randn(e - s, generator=g, device=u.device)
        r[s:e] = 3.0 + 1.5 * torch.tanh(raw)
    return torch.clamp(torch.round(r * 2) / 2, 0.5, 5.0)


STRUCTURE_SEED = 20_000_263  # the pairs and the holdout of every seed


def make_ratings(n_users: int, n_items: int, n_ratings: int,
                 true_rank: int, noise: float, test_fraction: float,
                 power_law: float, seed: int, device) -> Ratings:
    """The whole set for one seed: pairs and holdout from the structure
    stream, relabelled and rated from the seed's."""
    gs = generator(STRUCTURE_SEED, device, 7)
    key = draw_pairs(n_users, n_items, n_ratings, power_law, gs, device)
    held = torch.zeros(n_ratings, dtype=torch.bool, device=device)
    held[torch.randperm(n_ratings, generator=gs, device=device)[
        :int(n_ratings * test_fraction)]] = True
    g = generator(seed, device)
    order = torch.randperm(n_ratings, generator=g, device=device)
    key, held = key[order], held[order]
    u = torch.randperm(n_users, generator=g, device=device)[key // n_items]
    i = torch.randperm(n_items, generator=g, device=device)[key % n_items]
    del key, order
    sd = 1.0 / math.sqrt(true_rank)
    P = sd * torch.randn(n_users, true_rank, generator=g, device=device)
    Q = sd * torch.randn(n_items, true_rank, generator=g, device=device)
    r = planted_ratings(u, i, P, Q, noise, g)
    te, tr = held, ~held
    return Ratings(u[tr], i[tr], r[tr], u[te], i[te], r[te], P, Q,
                   n_users, n_items)


def make_for(config: dict, seed: int, device) -> Ratings:
    """``make_ratings`` with a configuration file's sizes and its
    ``assumed`` generator settings."""
    a = config["assumed"]["generator"]
    return make_ratings(config["n_users"], config["n_items"],
                        config["n_ratings"], a["true_rank"], a["noise"],
                        config["test_fraction"], a["power_law"], seed,
                        device)


def start_factors(n: int, rank: int, scale: float, seed: int, device,
                  stream: int) -> torch.Tensor:
    """``[n + 1, rank]`` float32 normal(0, scale) rows and a zero trash
    row: a training run's start (``init_state``'s distribution)."""
    g = generator(seed, device, stream)
    F = torch.zeros(n + 1, rank, dtype=torch.float32, device=device)
    F[:n] = scale * torch.randn(n, rank, generator=g, device=device)
    return F


def served_factors(planted: torch.Tensor, rank: int, noise: float,
                   seed: int, device, stream: int) -> torch.Tensor:
    """``[n + 1, rank]`` float32 factors with a trained model's structure:
    the planted rank-r factors in the first r columns, small seeded noise
    over all ``rank`` columns, and a zero trash row."""
    n, r = planted.shape
    g = generator(seed, device, stream)
    F = torch.zeros(n + 1, rank, dtype=torch.float32, device=device)
    F[:n, :r] = planted
    F[:n] += noise * torch.randn(n, rank, generator=g, device=device)
    return F

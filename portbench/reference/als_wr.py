"""Plain reference of ALS-WR (Zhou et al. 2008): the weighted-lambda
ridge ``lam * n_e`` on each entity's normal equations, user half-step
then item half-step against the new users."""

from __future__ import annotations

from portbench.reference import mf


def epoch(V, lists_u, lists_i, config: dict, gather: str):
    """``(U, V)`` float64 after one epoch from the item table ``V``."""
    return mf.epoch(V, lists_u, lists_i, config["lam"], None, gather)

"""Plain reference of implicit ALS (Hu, Koren & Volinsky 2008): confidence
``c = 1 + alpha r`` on observed pairs with preference 1, the full Gram of
the other side plus the confidence-weighted rated rows, ridge ``lam``."""

from __future__ import annotations

from portbench.reference import mf


def epoch(V, lists_u, lists_i, config: dict, gather: str):
    """``(U, V)`` float64 after one epoch from the item table ``V``."""
    return mf.epoch(V, lists_u, lists_i, config["lam"], config["alpha"],
                    gather)

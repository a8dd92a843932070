"""Plain reference of ALS-WR (Zhou et al. 2008) at wide ranks: the
weighted-lambda ridge ``lam * n_e`` on each entity's normal equations,
user half-step then item half-step against the new users, as
``als_wr.py``, in smaller float64 blocks.

``mf.solve_side``'s default blocks hold up to 32,768 entities and 2^22
padded slots; at k 256 a block's A, its Cholesky factor and the ridge
term would take ~17 GB each and its gathered rows ~8.6 GB. Here a block
holds at most ``MAX_BATCH`` entities (A, L and the ridge term 1.07 GB
each at k 256) and ``BUDGET`` padded slots (the gathered rows 2.1 GB).
Blocking changes which entities are solved together, not their
equations: every entity is solved, each on its own.
"""

from __future__ import annotations

from portbench.reference import mf

MAX_BATCH = 1 << 11  # entities a block
BUDGET = 1 << 20  # padded rating slots a block


def epoch(V, lists_u, lists_i, config: dict, gather: str):
    """``(U, V)`` float64 after one epoch from the item table ``V``."""
    lam = config["lam"]
    U = mf.solve_side(V.double(), lists_u, lam, None, gather,
                      budget=BUDGET, max_batch=MAX_BATCH)
    return U, mf.solve_side(U, lists_i, lam, None, gather, budget=BUDGET,
                            max_batch=MAX_BATCH)

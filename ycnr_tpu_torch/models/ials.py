"""Implicit weighted ALS on the blocked layout (counterpart of
``ycnr_tpu/models/ials.py``).

Preferences p = 1 on observed pairs, confidence c = 1 + alpha * r. The
per-entity system is (F^T F + F^T (C_e - I) F + lam I) x = F^T C_e p: the
global Gram F^T F is taken once per half-sweep and each block adds only
the observed entries' correction, through the same chunk path as ALS-WR.
Phases update E in place, as in ``models/als.py``.
"""

from __future__ import annotations

import torch

from ycnr_tpu_torch.models.base import MFState
from ycnr_tpu_torch.ops.gram import BlockData, solve_block
from ycnr_tpu_torch.ops.layout import BlockedCSR


def _phase(E_pad: torch.Tensor, F_pad: torch.Tensor, layout: BlockedCSR,
           lam: float, alpha: float) -> torch.Tensor:
    # global Gram once per half-sweep; the zero trailing row adds nothing
    G = F_pad.T @ F_pad
    for blk in zip(*layout):
        eid, rows = solve_block(F_pad, BlockData(*blk), lam,
                                gram_weight_alpha=alpha, base_gram=G,
                                base_reg=lam)
        E_pad[eid] = rows.to(E_pad.dtype)
    return E_pad


def ials_epoch(state: MFState, user_layout: BlockedCSR,
               item_layout: BlockedCSR, lam: float,
               alpha: float) -> MFState:
    U = _phase(state.U, state.V, user_layout, lam, alpha)
    V = _phase(state.V, U, item_layout, lam, alpha)
    return state._replace(U=U, V=V)


class ImplicitALS:
    """Engine-facing iALS trainer (BASELINE.json capability)."""

    def __init__(self, lam: float = 0.1, alpha: float = 40.0):
        self.lam = float(lam)
        self.alpha = float(alpha)

    def epoch(self, state: MFState, user_layout: BlockedCSR,
              item_layout: BlockedCSR) -> MFState:
        return ials_epoch(state, user_layout, item_layout, self.lam,
                          self.alpha)

"""ALS-WR on the blocked layout (counterpart of ``ycnr_tpu/models/als.py``).

One epoch is a user phase, then an item phase against the new U. A phase
walks the layout block by block (the reference's ``lax.scan`` becomes a
loop) and writes each block's solved rows into E in place: blocks of one
phase read only the other factor, so the order of the writes does not
matter, and padding slots all write the trash row with zeros.
"""

from __future__ import annotations

import torch

from ycnr_tpu_torch.models.base import MFState
from ycnr_tpu_torch.ops.gram import BlockData, solve_block
from ycnr_tpu_torch.ops.layout import BlockedCSR


def _phase(E_pad: torch.Tensor, F_pad: torch.Tensor, layout: BlockedCSR,
           lam: float) -> torch.Tensor:
    """Re-solve every entity row of E against fixed F (one half-sweep)."""
    for blk in zip(*layout):
        eid, rows = solve_block(F_pad, BlockData(*blk), lam)
        E_pad[eid] = rows.to(E_pad.dtype)
    return E_pad


def als_epoch(state: MFState, user_layout: BlockedCSR,
              item_layout: BlockedCSR, lam: float) -> MFState:
    """One full ALS-WR epoch: solve U against V, then V against the new U.
    The returned state shares the input's tensors, updated in place."""
    U = _phase(state.U, state.V, user_layout, lam)
    V = _phase(state.V, U, item_layout, lam)
    return state._replace(U=U, V=V)


class ALSWR:
    """Engine-facing ALS-WR trainer; layouts come from
    ``models.base.device_layout``."""

    def __init__(self, lam: float = 0.05):
        self.lam = float(lam)

    def epoch(self, state: MFState, user_layout: BlockedCSR,
              item_layout: BlockedCSR) -> MFState:
        return als_epoch(state, user_layout, item_layout, self.lam)

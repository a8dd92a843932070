"""Guarded batched solve of the ALS normal equations.

Counterpart of ``ycnr_tpu/ops/gram.py:guarded_batched_solve``. The blocked
path's ``chunk_gram_rhs`` / ``segment_reduce_block`` / ``solve_block`` are
not ported yet; the bucketed phase (``models/bucketed_phase.py``) calls this
function directly.
"""

from __future__ import annotations

import torch

from ycnr_tpu_torch.ops.spd_solve import spd_solve


def guarded_batched_solve(A: torch.Tensor, b: torch.Tensor,
                          reg: torch.Tensor) -> torch.Tensor:
    """Solve (A + reg * I) x = b per batch element.

    reg: [B] per-entity ridge; callers pass lam*n_e + (n_e==0) so empty
    slots solve I x = 0 -> exactly 0. The ridge is added before the
    symmetrization, in the reference's order. On the CPU the solve is the
    plain Cholesky; on CUDA it is K1 (``ops/spd_solve.py``), which raises
    for what it does not take (float64, n > 128).
    """
    k = A.shape[-1]
    eye = torch.eye(k, dtype=A.dtype, device=A.device)
    A = A + reg[:, None, None] * eye
    A = 0.5 * (A + A.transpose(-1, -2))  # enforce symmetry
    return spd_solve(A, b)

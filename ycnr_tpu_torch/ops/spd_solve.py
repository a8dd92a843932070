"""Batched SPD solve: the K1 wrapper, its plain version and a launch count.

Counterpart of ``ycnr_tpu/ops/pallas_solve.py``. ``spd_solve`` takes
``A [B, n, n]`` (symmetric positive definite; ridge and guard already
added) and ``b [B, n]`` and returns ``x [B, n]``. A tensor on the CPU goes
to ``spd_solve_reference``; a CUDA float32 tensor with ``n <= 128`` goes to
the hand-written kernel ``csrc/spd_solve.cu``; any other CUDA tensor raises.
"""

from __future__ import annotations

import torch

from ycnr_tpu_torch.ops import _build

MAX_N = 128

launches = 0  # K1 launches since the last reset (chip_smoke reads it)


def spd_solve_reference(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version: Cholesky factor, then two triangular solves."""
    L = torch.linalg.cholesky(A)
    return torch.cholesky_solve(b[..., None], L)[..., 0]


def spd_solve_cuda(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch K1 on PyTorch's current stream (no synchronization)."""
    global launches
    if not (A.is_cuda and b.is_cuda and A.device == b.device):
        raise ValueError("spd_solve_cuda needs A and b on one CUDA device")
    if A.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"K1 takes float32, got {A.dtype} / {b.dtype}")
    if A.dim() != 3 or A.shape[1] != A.shape[2] or b.shape != A.shape[:2]:
        raise ValueError(f"K1 takes A [B, n, n] and b [B, n], got "
                         f"{tuple(A.shape)} and {tuple(b.shape)}")
    B, n = b.shape
    if not 1 <= n <= MAX_N:
        raise ValueError(f"K1 takes n <= {MAX_N}, got n = {n}")
    if not (A.is_contiguous() and b.is_contiguous()):
        raise ValueError("K1 takes contiguous A and b")
    x = torch.empty_like(b)
    if B == 0:
        return x
    lib = _build.load_library()
    rc = lib.ycnr_spd_solve(A.data_ptr(), b.data_ptr(), x.data_ptr(), B, n,
                            torch.cuda.current_stream(A.device).cuda_stream)
    _build.check(rc, "ycnr_spd_solve")
    launches += 1
    return x


def spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = A^-1 b per system: the plain version on the CPU, K1 on CUDA."""
    if A.device.type == "cpu":
        return spd_solve_reference(A, b)
    return spd_solve_cuda(A, b)

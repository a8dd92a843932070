"""Batched SPD solve: the K1 wrapper, its plain version and a launch count.

Counterpart of ``ycnr_tpu/ops/pallas_solve.py``. ``spd_solve`` takes
``A [B, n, n]`` (symmetric positive definite; ridge and guard already
added) and ``b [B, n]`` and returns ``x [B, n]``. A tensor on the CPU goes
to ``spd_solve_reference``; a CUDA float32 tensor with ``n <= 256``
(``MAX_N``, the TPU kernel's own limit) goes to the hand-written kernel
``csrc/spd_solve.cu``; any other CUDA tensor raises.

Which body of the kernel runs follows from n alone: up to n = 64 one warp
solves a system with the matrix in registers, padded with an identity
block to 16, 32 or 64 columns (an LDL^T elimination, columns in order,
the right-hand side carried as one more row, then a back substitution);
up to n = 128 one block of 128 threads solves a system in shared memory;
above, one block of 256 threads keeps only the lower triangle, packed
column by column (``packed_index``), and runs a right-looking Cholesky in
panels of 8 columns (each panel factored left-looking with rsqrt pivots,
then the trailing triangle minus its rank-8 product), then the two
substitutions. All three are held to a
float64 solve within the forward error of an f32 Cholesky,
``cond(A) n 2^-24``; a padding system I x = 0 gives exactly 0.

A rule of the port: float64 systems are solved on the CPU only. The JAX
package sends them to XLA's Cholesky, a route its own code keeps "for
float64 parity runs and CPU tests" (``ycnr_tpu/ops/gram.py``); the port's
parity runs are CPU runs, so K1 has no double body and a CUDA float64
tensor raises.
"""

from __future__ import annotations

import torch

from ycnr_tpu_torch.ops import _build

MAX_N = 256

launches = 0  # K1 launches since the last reset (chip_smoke reads it)
# the same launches by the body that ran them ("warp" n <= 64, "block"
# n <= 128, "packed" above; ``body``), reset with ``launches``
body_launches = {"warp": 0, "block": 0, "packed": 0}


def spd_solve_reference(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version: Cholesky factor, then two triangular solves."""
    L = torch.linalg.cholesky(A)
    return torch.cholesky_solve(b[..., None], L)[..., 0]


def packed_index(r, c, n: int):
    """Offset of entry (r, c), r >= c, of an n x n lower triangle packed
    column by column, as the n > 128 body keeps it in shared memory
    (``csrc/spd_solve.cu:packed_index``): column c holds rows c .. n - 1
    and starts at c (2n - c + 1) / 2."""
    return c * (2 * n - c + 1) // 2 + (r - c)


def body(n: int) -> str:
    """Which body of K1 solves systems of size n (``csrc/spd_solve.cu``)."""
    return "warp" if n <= 64 else "block" if n <= 128 else "packed"


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
                            _build.stream(A.device))
    _build.check(rc, "ycnr_spd_solve")
    launches += 1
    body_launches[body(n)] += 1
    return x


def spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = A^-1 b per system: the plain version on the CPU, K1 on CUDA."""
    if A.device.type == "cpu":
        return spd_solve_reference(A, b)
    return spd_solve_cuda(A, b)

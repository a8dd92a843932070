"""Fused gather -> Gram: the wrapper of ``csrc/fused_gram.cu``, its plain
version and a launch count.

Counterpart of ``tools/probe_gather.py:pallas_fused_gram`` (T4). For
every entity e of a block, from the bf16 factor table and the entity's
R rating slots::

    A[e] = sum_r F[idx[e, r]] F[idx[e, r]]^T      [w, w] f32
    b[e] = sum_r rat[e, r] F[idx[e, r]]            [w]    f32

which is the bucketed ALS-WR phase's gather + ``bucket_normal_eq`` with
bf16 gathers (``models/bucketed_phase.py``). The kernel never writes the
gathered rows to device memory. A tensor on the CPU goes to the plain
version; a CUDA tensor goes to the kernel, and what it does not take
raises.

The two differ only in the order of the f32 sums (every product of two
bf16 values is exact in f32), so for each entry
``|A - A_plain| <= 2 R 2^-24 (|F|^T |F|)``, and the same bound holds for
b with ``|rat|`` in place of one ``|F|``.
"""

from __future__ import annotations

import torch

from ycnr_tpu_torch.ops import _build

MAX_W = 128  # K1's limit, so the kernel covers every rank the solve takes

# The kernel runs one block per entity. A call with fewer entities than
# this many blocks (two per SM of an H100) cuts each long rating list into
# parts of at least _MIN_PART slots, one block each, and sums the parts.
_FILL_BLOCKS = 264
_MIN_PART = 256

launches = 0  # kernel launches since the last reset


def fused_gram_reference(table: torch.Tensor, idx: torch.Tensor,
                         rat: torch.Tensor):
    """The plain two-step version: gather, widen to f32, two einsums.

    On CUDA the caller keeps TF32 off (``full_precision_matmul``), as every
    entry point of the port does.
    """
    F = table[idx].float()
    A = torch.einsum("urk,urm->ukm", F, F)
    b = torch.einsum("urk,ur->uk", F, rat.float())
    return A, b


def fused_gram_bound(F: torch.Tensor, rat: torch.Tensor):
    """The elementwise tolerances between the kernel and the plain
    version: ``2 R 2^-24 (|F|^T |F|)`` for A and ``2 R 2^-24 (|F|^T
    |rat|)`` for b, from the gathered rows F [NE, R, w] (float) and the
    ratings rat [NE, R]."""
    Fa = F.abs()
    c = 2.0 * F.shape[1] * 2.0 ** -24
    return (c * torch.einsum("urk,urm->ukm", Fa, Fa),
            c * torch.einsum("urk,ur->uk", Fa, rat.to(F.dtype).abs()))


def _parts(ne: int, R: int) -> int:
    s = 1
    while (ne * s < _FILL_BLOCKS and R % (2 * s) == 0
           and R // (2 * s) >= _MIN_PART):
        s *= 2
    return s


def fused_gram_cuda(table: torch.Tensor, idx: torch.Tensor,
                    rat: torch.Tensor):
    """Launch the fused kernel on PyTorch's current stream.

    table [n, w] bf16 (w <= 128), idx [NE, R] int32/int64, rat [NE, R]
    bf16 -> (A [NE, w, w] f32, b [NE, w] f32).
    """
    global launches
    dev = table.device
    if not all(t.is_cuda and t.device == dev for t in (table, idx, rat)):
        raise ValueError("fused_gram needs all inputs on one CUDA device")
    if table.dtype != torch.bfloat16 or rat.dtype != torch.bfloat16:
        raise TypeError(f"fused_gram takes a bf16 table and bf16 ratings, "
                        f"got {table.dtype} / {rat.dtype}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"fused_gram takes int32 or int64 indices, got "
                        f"{idx.dtype}")
    if table.dim() != 2 or idx.dim() != 2 or rat.shape != idx.shape:
        raise ValueError(f"fused_gram takes table [n, w], idx and rat "
                         f"[NE, R], got {tuple(table.shape)}, "
                         f"{tuple(idx.shape)}, {tuple(rat.shape)}")
    n, w = table.shape
    if not 1 <= w <= MAX_W:
        raise ValueError(f"fused_gram takes w <= {MAX_W}, got w = {w}")
    if not all(t.is_contiguous() for t in (table, idx, rat)):
        raise ValueError("fused_gram takes contiguous inputs")
    ne, R = idx.shape
    if ne == 0 or R == 0:
        return (torch.zeros(ne, w, w, dtype=torch.float32, device=dev),
                torch.zeros(ne, w, dtype=torch.float32, device=dev))
    if n == 0:
        raise IndexError("fused_gram: indices into an empty table")
    s = _parts(ne, R)
    A = torch.empty(ne * s, w, w, dtype=torch.float32, device=dev)
    b = torch.empty(ne * s, w, dtype=torch.float32, device=dev)
    lib = _build.load_library()
    rc = lib.ycnr_fused_gram(
        table.data_ptr(), idx.data_ptr(), rat.data_ptr(), A.data_ptr(),
        b.data_ptr(), ne * s, R // s, w, n, int(idx.dtype == torch.int64),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "ycnr_fused_gram")
    launches += 1
    if s == 1:
        return A, b
    # the same reduction order for every entry: A stays bit-symmetric
    return A.view(ne, s, w, w).sum(1), b.view(ne, s, w).sum(1)


def fused_gram(table: torch.Tensor, idx: torch.Tensor, rat: torch.Tensor):
    """(A, b) per entity: the plain version on the CPU, the kernel on
    CUDA."""
    if table.device.type == "cpu":
        return fused_gram_reference(table, idx, rat)
    return fused_gram_cuda(table, idx, rat)

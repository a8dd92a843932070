"""Indexed row gather: the wrapper of ``csrc/row_gather.cu``, its plain
version and a launch count.

Counterpart of the JAX package's five TPU gathers, which all compute
``table[idx]``: ``tools/probe_gather.py`` ``pallas_loop_gather`` (T1),
``pallas_take_gather`` (T2) and ``pallas_taa_gather`` (T3, 2-D indices:
``take_along_rows`` here), ``tools/bench_pallas_gather.py``
``pallas_vmem_gather`` (T5) and ``pallas_hbm_dma_gather`` (T6). The port
runs it wherever the JAX package gathers factor rows on the device path:
the blocked solve (``ops/gram.solve_block``), the bucketed phase and
fold-in.

A tensor on the CPU goes to the plain version; a CUDA tensor goes to the
kernel, and what the kernel does not take raises. Indices must lie in
``[0, n)``: the kernel stops on any other (the plain version, PyTorch
indexing, would wrap a negative one).
"""

from __future__ import annotations

import torch

from ycnr_tpu_torch.ops import _build

launches = 0  # row_gather kernel launches since the last reset
take_launches = 0  # take_along_rows kernel launches since the last reset

_INDEX_DTYPES = (torch.int32, torch.int64)


def row_gather_reference(table: torch.Tensor, idx: torch.Tensor):
    """The plain version: ``table[idx]``."""
    return table[idx]


def _check(table, idx, what):
    if not (table.is_cuda and idx.is_cuda and table.device == idx.device):
        raise ValueError(f"{what} needs table and indices on one CUDA "
                         f"device")
    if idx.dtype not in _INDEX_DTYPES:
        raise TypeError(f"{what} takes int32 or int64 indices, got "
                        f"{idx.dtype}")
    if table.dim() != 2:
        raise ValueError(f"{what} takes a [n, w] table, got "
                         f"{tuple(table.shape)}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{what} takes a contiguous table and indices")


def row_gather_cuda(table: torch.Tensor, idx: torch.Tensor):
    """Launch the gather kernel on PyTorch's current stream.

    table [n, w] (any dtype), idx of any shape, int32 or int64 ->
    ``idx.shape + (w,)``, bit-equal to ``table[idx]``.
    """
    global launches
    _check(table, idx, "row_gather")
    n, w = table.shape
    out = torch.empty(*idx.shape, w, dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out
    if n == 0:
        raise IndexError("row_gather: indices into an empty table")
    lib = _build.load_library()
    rc = lib.ycnr_row_gather(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(), n,
        w * table.element_size(), int(idx.dtype == torch.int64),
        _build.stream(table.device))
    _build.check(rc, "ycnr_row_gather")
    launches += 1
    return out


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``: the plain version on the CPU, the kernel on CUDA."""
    if table.device.type == "cpu":
        return row_gather_reference(table, idx)
    return row_gather_cuda(table, idx)


def take_along_rows_reference(table: torch.Tensor, idx2: torch.Tensor):
    """The plain version: ``torch.gather(table, 0, idx2)``."""
    return torch.gather(table, 0, idx2.long())


def take_along_rows_cuda(table: torch.Tensor, idx2: torch.Tensor):
    """Launch the take-along kernel: out[i, j] = table[idx2[i, j], j].

    table [n, w] bf16/f32 (or any 2- or 4-byte dtype), idx2 [m, c] with
    c <= w, int32 or int64 -> [m, c], bit-equal to ``torch.gather``. The
    kernel moves 16-byte runs of output with 16-byte index loads, and one
    16-byte table load where a run's indices are all equal (row-broadcast
    indices, T3's form).
    """
    global take_launches
    _check(table, idx2, "take_along_rows")
    n, w = table.shape
    if table.element_size() not in (2, 4):
        raise TypeError(f"take_along_rows takes 2- or 4-byte elements, got "
                        f"{table.dtype}")
    if idx2.dim() != 2 or idx2.shape[1] > w:
        raise ValueError(f"take_along_rows takes idx2 [m, c <= {w}], got "
                         f"{tuple(idx2.shape)}")
    m, c = idx2.shape
    out = torch.empty(m, c, dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out
    if n == 0:
        raise IndexError("take_along_rows: indices into an empty table")
    lib = _build.load_library()
    rc = lib.ycnr_take_along_rows(
        table.data_ptr(), idx2.data_ptr(), out.data_ptr(), m, c, w, n,
        table.element_size(), int(idx2.dtype == torch.int64),
        _build.stream(table.device))
    _build.check(rc, "ycnr_take_along_rows")
    take_launches += 1
    return out


def take_along_rows(table: torch.Tensor, idx2: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(table, idx2, 0)``: plain on the CPU, the kernel on
    CUDA."""
    if table.device.type == "cpu":
        return take_along_rows_reference(table, idx2)
    return take_along_rows_cuda(table, idx2)

"""Fused gather -> Gram with the ridge: the wrapper of
``csrc/fused_gram.cu``, its plain version and a launch count.

Counterpart of ``tools/probe_gather.py:pallas_fused_gram`` (T4). For
every entity e of a block, from the bf16 factor table and the entity's
R rating slots::

    A[e] = sum_r F[idx[e, r]] F[idx[e, r]]^T + reg[e] I    [w, w] f32
    b[e] = sum_r rat[e, r] F[idx[e, r]]                    [w]    f32

which is the bucketed ALS-WR phase's gather + ``bucket_normal_eq`` with
bf16 gathers, followed by the ridge and symmetrization that
``ops/gram.guarded_batched_solve`` applies before its solve
(``models/bucketed_phase.py``). ``reg`` is optional; without it there is
no ridge. The kernel never writes the gathered rows to device memory and
runs the products on the tensor cores. A tensor on the CPU goes to the
plain version; a CUDA tensor goes to the kernel, and what it does not
take raises.

Numbers. Every product of two bf16 values is exact in f32, so the two
versions differ only in how the sums are rounded. The plain version sums
in f32 with round-to-nearest: at most R 2^-24 sum|p| per entry. Hopper's
tensor cores do not promise round-to-nearest inside an ``mma``: a step
adds 16 products to the accumulator after aligning them to the largest
exponent and may truncate, which costs at most 18 ulps of the largest of
those 17 terms, i.e. 36 2^-24 of their absolute sum; a partial sum takes
ceil(R / 16) such steps, then up to three adds across warps and the
adds across parts. Together, with a factor of two to spare::

    |A - A_plain| <= (6 R + 128) 2^-24 (|F|^T |F|) + 2^-22 reg I
    |b - b_plain| <= (6 R + 128) 2^-24 (|F|^T |rat|)

the last term because both versions round their sum plus the ridge.
That bound is a worst case and grows with R: at the main path's longest
lists it would pass a sum that lost a few percent of its slots. So the
kernel is also held, entry by entry, to a float64 sum of the same products
(``fused_gram_f64_error``), relative to |F|^T|F| + reg I, within
``F64_REL``.
The kernel's A is bit-symmetric by construction (it computes the lower
triangle and mirrors it); a padding entity (only the all-zero trash row)
comes out exactly A = reg I, b = 0.

Two bodies: w <= 128 (``NARROW_W``) runs the 4-warp body, whose warps
may split a stage's 16-slot steps and then add up to four partials;
128 < w <= 256 runs the 8-warp wide body, in which every entry of A and b
is one warp's chain of ceil(R / 16) steps in slot order, with no adds
across warps. Both bounds above therefore hold for the wide body for the
same reason, with three adds to spare, and ``F64_REL`` is held to it on
the card (``chip_smoke.py``) at w 192, 250 and 256: an entry's error
comes from the steps along R, whatever the width.
"""

from __future__ import annotations

from typing import Optional

import torch

from ycnr_tpu_torch.ops import _build

MAX_W = 256  # the kernel's width limit, K1's too
NARROW_W = 128  # the widest rows of the 4-warp body; wider: the wide body

# The kernel runs one block per entity. A call with fewer entities than
# the body's fill cuts each long rating list into parts of at least
# _MIN_PART slots, one block each, and sums the parts. The 4-warp body
# keeps three blocks resident per SM of an H100 (396); the wide body one
# (~190 registers a thread x 256 threads), so its fill is two waves of
# 132, the second evening out the first's ragged end.
_FILL_BLOCKS = 396
_FILL_BLOCKS_WIDE = 264
_MIN_PART = 256

launches = 0  # kernel launches since the last reset

# The kernel's largest error against a float64 sum, relative to
# |F|^T|F| + reg I (``fused_gram_f64_error``), that its checks allow:
# about seven times the largest that chip_smoke.py measured on the main
# path's blocks (2.8e-7, at R = 129,872; H100 80GB HBM3), where the plain
# f32 version's error reached 1.4e-5 and a sum that leaves out one part of
# a split list is off by far more.
F64_REL = 2.0 ** -19


def fused_gram_reference(table: torch.Tensor, idx: torch.Tensor,
                         rat: torch.Tensor,
                         reg: Optional[torch.Tensor] = None):
    """The plain version: gather, widen to f32 (f64 stays f64), two
    einsums; with ``reg``, add ``reg I`` and then symmetrize, in the order
    of ``ops/gram.guarded_batched_solve``, so on the CPU its A is the one
    that function hands to the solve.

    On CUDA the caller keeps TF32 off (``full_precision_matmul``), as every
    entry point of the port does.
    """
    F = table[idx]
    F = F.to(torch.promote_types(F.dtype, torch.float32))
    A = torch.einsum("urk,urm->ukm", F, F)
    b = torch.einsum("urk,ur->uk", F, rat.to(F.dtype))
    if reg is not None:
        eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
        A = A + reg.to(A.dtype)[:, None, None] * eye
        A = 0.5 * (A + A.transpose(-1, -2))
    return A, b


def fused_gram_bound(F: torch.Tensor, rat: torch.Tensor,
                     reg: Optional[torch.Tensor] = None):
    """The elementwise tolerances between the kernel and the plain version
    (module docstring), from the gathered rows F [NE, R, w] (float), the
    ratings rat [NE, R] and the ridge reg [NE] or None."""
    Fa = F.abs()
    c = (6.0 * F.shape[1] + 128.0) * 2.0 ** -24
    bA = c * torch.einsum("urk,urm->ukm", Fa, Fa)
    if reg is not None:
        bA = bA + (2.0 ** -22 * reg.to(F.dtype).abs())[:, None, None] * \
            torch.eye(F.shape[-1], dtype=F.dtype, device=F.device)
    return bA, c * torch.einsum("urk,ur->uk", Fa, rat.to(F.dtype).abs())


def fused_gram_f64_error(table: torch.Tensor, idx: torch.Tensor,
                         rat: torch.Tensor, reg: Optional[torch.Tensor],
                         A: torch.Tensor, b: torch.Tensor):
    """(A's, b's) largest error against a float64 sum of the same
    products, entry by entry relative to |F|^T|F| + |reg| I and
    |F|^T|rat| (F = table[idx] widened). A padding entity's entries are
    exact or count as infinitely wrong."""
    F = table[idx].double()
    Fa, r = F.abs(), rat.double()
    A64 = torch.einsum("urk,urm->ukm", F, F)
    sA = torch.einsum("urk,urm->ukm", Fa, Fa)
    if reg is not None:
        eye = torch.eye(F.shape[-1], dtype=F.dtype, device=F.device)
        A64 = A64 + reg.double()[:, None, None] * eye
        sA = sA + reg.double().abs()[:, None, None] * eye
    b64 = torch.einsum("urk,ur->uk", F, r)
    sb = torch.einsum("urk,ur->uk", Fa, r.abs())
    eA = (A.double() - A64).abs() / sA.clamp_min(1e-300)
    eb = (b.double() - b64).abs() / sb.clamp_min(1e-300)
    return eA.max().item(), eb.max().item()


def fill_blocks(w: int) -> int:
    """The fill of the body that runs at width w (``_parts``' ``fill``)."""
    return _FILL_BLOCKS if w <= NARROW_W else _FILL_BLOCKS_WIDE


def _parts(ne: int, R: int, fill: int = _FILL_BLOCKS):
    """(parts, slots per part): enough parts of at least _MIN_PART slots
    for ne * parts to reach ``fill`` (``fill_blocks(w)``); the last part
    may be shorter."""
    s = max(1, min(-(-fill // ne), R // _MIN_PART))
    r_part = -(-R // s)
    return -(-R // r_part), r_part


def fused_gram_cuda(table: torch.Tensor, idx: torch.Tensor,
                    rat: torch.Tensor, reg: Optional[torch.Tensor] = None):
    """Launch the fused kernel on PyTorch's current stream.

    table [n, w] bf16 (w <= 256), idx [NE, R] int32/int64, rat [NE, R]
    bf16, reg [NE] f32 or None -> (A [NE, w, w] f32, b [NE, w] f32).
    """
    global launches
    dev = table.device
    ins = (table, idx, rat) + (() if reg is None else (reg,))
    if not all(t.is_cuda and t.device == dev for t in ins):
        raise ValueError("fused_gram needs all inputs on one CUDA device")
    if table.dtype != torch.bfloat16 or rat.dtype != torch.bfloat16:
        raise TypeError(f"fused_gram takes a bf16 table and bf16 ratings, "
                        f"got {table.dtype} / {rat.dtype}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"fused_gram takes int32 or int64 indices, got "
                        f"{idx.dtype}")
    if reg is not None and reg.dtype != torch.float32:
        raise TypeError(f"fused_gram takes an f32 ridge, got {reg.dtype}")
    if table.dim() != 2 or idx.dim() != 2 or rat.shape != idx.shape:
        raise ValueError(f"fused_gram takes table [n, w], idx and rat "
                         f"[NE, R], got {tuple(table.shape)}, "
                         f"{tuple(idx.shape)}, {tuple(rat.shape)}")
    ne, R = idx.shape
    if reg is not None and reg.shape != (ne,):
        raise ValueError(f"fused_gram takes reg [NE], got "
                         f"{tuple(reg.shape)}")
    n, w = table.shape
    if not 1 <= w <= MAX_W:
        raise ValueError(f"fused_gram takes w <= {MAX_W}, got w = {w}")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("fused_gram takes contiguous inputs")
    if ne == 0 or R == 0:
        A = torch.zeros(ne, w, w, dtype=torch.float32, device=dev)
        if reg is not None:
            A.diagonal(dim1=1, dim2=2).copy_(reg[:, None].expand(ne, w))
        return A, torch.zeros(ne, w, dtype=torch.float32, device=dev)
    if n == 0:
        raise IndexError("fused_gram: indices into an empty table")
    s, r_part = _parts(ne, R, fill_blocks(w))
    A = torch.empty(ne * s, w, w, dtype=torch.float32, device=dev)
    b = torch.empty(ne * s, w, dtype=torch.float32, device=dev)
    lib = _build.load_library()
    rc = lib.ycnr_fused_gram(
        table.data_ptr(), idx.data_ptr(), rat.data_ptr(),
        reg.data_ptr() if reg is not None and s == 1 else None,
        A.data_ptr(), b.data_ptr(), ne, R, s, r_part, w, n,
        int(idx.dtype == torch.int64),
        _build.stream(dev))
    _build.check(rc, "ycnr_fused_gram")
    launches += 1
    if s == 1:
        return A, b
    # the same reduction order for every entry: A stays bit-symmetric; the
    # ridge goes on once, after the parts are summed
    A, b = A.view(ne, s, w, w).sum(1), b.view(ne, s, w).sum(1)
    if reg is not None:
        A.diagonal(dim1=1, dim2=2).add_(reg[:, None])
    return A, b


def fused_gram(table: torch.Tensor, idx: torch.Tensor, rat: torch.Tensor,
               reg: Optional[torch.Tensor] = None):
    """(A, b) per entity: the plain version on the CPU, the kernel on
    CUDA."""
    if table.device.type == "cpu":
        return fused_gram_reference(table, idx, rat, reg)
    return fused_gram_cuda(table, idx, rat, reg)

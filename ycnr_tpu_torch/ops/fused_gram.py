"""Fused gather -> Gram with the ridge: the wrapper of
``csrc/fused_gram.cu``, its plain version and launch counts.

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

Weighted mode (``alpha`` given; iALS; w <= ``NARROW_W`` on the card)::

    wt = bf16(alpha rat), c = bf16(1 + wt)          per slot
    A[e] = sum_r wt F F^T + base + reg I,   b[e] = sum_r c F

with ``base`` an optional symmetric [w, w] f32 addend (iALS's base Gram,
symmetrized once a phase) and ``reg`` one float; the plain mode's ``reg``
is a tensor [NE]. That is
``bucket_normal_eq`` with ``alpha`` and bf16 gathers followed by
``bucket_finish_solve``'s base Gram, ridge and symmetrization, which is
the order the plain version keeps. The kernel weighs the staged ratings
itself (``weights``, the one rounding rule of both routes) and adds base
and ridge in its epilogue; its A is bit-symmetric when base is.

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
comes out exactly A = reg I, b = 0 (weighted: base + reg I).

Two bodies: w <= 128 (``NARROW_W``) runs the 4-warp body, whose warps
may split a stage's 16-slot steps and then add up to four partials;
128 < w <= 256 runs the wide body (``wgmma`` on a warp-specialised ring,
persistent blocks), in which every entry of A and b is one warpgroup's
chain of ``wgmma m64nNk16`` steps in slot order (ceil(R / 16) that carry
products; the rest of the last 64-slot stage adds exact zeros), with no
adds across warpgroups. A ``wgmma`` k16 step falls under the same argument as
an ``mma.sync m16n8k16`` step: it adds 16 exact products of bf16 values to
the f32 accumulator, one chain an entry. So both bounds above hold for the
wide body for the same reason, with three adds to spare, and ``F64_REL``
is held to it on the card (``chip_smoke.py``) at w 192, 250 and 256: an
entry's error comes from the steps along R, whatever the width.

The weighted mode's products are as exact: wt F_i, a product of two bf16
values, has at most 16 significant bits, so it splits exactly into hi
(its top 8 bits) and lo (the rest), both bf16 with one sign, and the
kernel runs two ``mma`` steps a 16-slot step, lo F_j then hi F_j, each
of exact products whose sum is wt F_i F_j, into a zeroed step sum; one
f32 add (round to nearest) puts it on the running sum. Each step sum
costs at most 2 x 36 2^-24 of its terms' absolute sum (the argument
above; |hi F_j| + |lo F_j| = |wt F_i F_j|), ceil(R / 16) steps at most
72 2^-24 of the whole, and each add 2^-24 of the running sum, so the
chain's error is below the plain mode's: the same bound holds, the sums
of base and ridge added (once each in both versions, relative to |P| +
|base| + reg)::

    |A - A_plain| <= (6 R + 128) 2^-24 (|F|^T wt |F|)
                     + 2^-21 (|base| + |reg| I)
    |b - b_plain| <= (6 R + 128) 2^-24 (|F|^T |c|)

and ``fused_gram_f64_error`` takes the weights and base alike; the card
holds the weighted kernel within ``F64_REL`` too. (Two ``mma`` steps into
the running sum itself measured 2.3e-6 to 4.7e-6 against float64, above
``F64_REL``: the lo products, ~2^-8 of the running sum's terms, lost
their low bits to its alignment in every step.)
"""

from __future__ import annotations

from typing import Optional

import torch

from ycnr_tpu_torch.ops import _build
from ycnr_tpu_torch.utils.profiling import span

MAX_W = 256  # the kernel's width limit, K1's too
NARROW_W = 128  # the widest rows of the 4-warp body; wider: the wide body

# The kernel runs one block per (entity, part) item. A call with fewer
# entities than the body's fill cuts each long rating list into parts of
# at least _MIN_PART slots, one item each, and sums the parts. The 4-warp
# body keeps three blocks resident per SM of an H100 (396). The wide body
# runs one persistent block an SM (132, ~200 KB of shared memory each),
# which walk the items in a fixed stride: its fill is two items a block,
# the second evening out the first's ragged end.
_FILL_BLOCKS = 396
_FILL_BLOCKS_WIDE = 264
_MIN_PART = 256

launches = 0  # kernel launches since the last reset
weighted_launches = 0  # of them, in the weighted mode
split_launches = 0  # of them, with s > 1 parts (``_parts``), summed after
# bytes of those calls' partial A and b: written by the kernel, then read
# back by the sum (``part_bytes_of``), since the same reset
part_bytes = 0

# The kernel's largest error against a float64 sum, relative to
# |F|^T|F| + reg I (``fused_gram_f64_error``), that its checks allow:
# about seven times the largest that chip_smoke.py measured on the main
# path's blocks (2.8e-7, at R = 129,872; H100 80GB HBM3), where the plain
# f32 version's error reached 1.4e-5 and a sum that leaves out one part of
# a split list is off by far more.
F64_REL = 2.0 ** -19


def weights(rat: torch.Tensor, alpha: float, dtype: torch.dtype):
    """The weighted mode's per-slot (wt, c), as the einsum route
    (``bucket_normal_eq``) and the kernel round them: wt = alpha rat in
    ``rat``'s dtype (bf16 stays bf16), c = 1 + wt in ``dtype`` (the
    table's)."""
    wt = alpha * rat
    return wt, (1.0 + wt).to(dtype)


def _diag(reg, like: torch.Tensor) -> torch.Tensor:
    """The ridge as a [NE or 1, 1, 1] column in ``like``'s dtype: reg a
    tensor [NE] (plain mode) or one float (weighted mode)."""
    return torch.as_tensor(reg, dtype=like.dtype,
                           device=like.device).reshape(-1, 1, 1)


def fused_gram_reference(table: torch.Tensor, idx: torch.Tensor,
                         rat: torch.Tensor, reg=None, *,
                         alpha: Optional[float] = None,
                         base: Optional[torch.Tensor] = None):
    """The plain version: gather, widen to f32 (f64 stays f64), two
    einsums (with ``alpha``: the weighted A and c's b, as
    ``bucket_normal_eq``); then ``+ base``, ``+ reg I`` and, with either,
    symmetrize, in the order of ``bucket_finish_solve`` and
    ``ops/gram.guarded_batched_solve``, so on the CPU its A is the one
    those hand to the solve.

    On CUDA the caller keeps TF32 off (``full_precision_matmul``), as every
    entry point of the port does.
    """
    F = table[idx]
    F = F.to(torch.promote_types(F.dtype, torch.float32))
    if alpha is None:
        A = torch.einsum("urk,urm->ukm", F, F)
        b = torch.einsum("urk,ur->uk", F, rat.to(F.dtype))
    else:
        wt, c = weights(rat, alpha, table.dtype)
        A = torch.einsum("urk,urm->ukm", F * wt.to(F.dtype)[..., None], F)
        b = torch.einsum("urk,ur->uk", F, c.to(F.dtype))
    if base is not None:
        A = A + base.to(A.dtype)[None]
    if reg is not None:
        eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
        A = A + _diag(reg, A) * eye
    if reg is not None or base is not None:
        A = 0.5 * (A + A.transpose(-1, -2))
    return A, b


def fused_gram_bound(F: torch.Tensor, rat: torch.Tensor, reg=None, *,
                     alpha: Optional[float] = None,
                     base: Optional[torch.Tensor] = None):
    """The elementwise tolerances between the kernel and the plain version
    (module docstring), from the gathered rows F [NE, R, w] (float), the
    ratings rat [NE, R], the ridge reg [NE], a float or None, and the
    weighted mode's alpha and base."""
    Fa = F.abs()
    R, w = F.shape[1], F.shape[-1]
    c = (6.0 * R + 128.0) * 2.0 ** -24
    eye = torch.eye(w, dtype=F.dtype, device=F.device)
    if alpha is None:
        bA = c * torch.einsum("urk,urm->ukm", Fa, Fa)
        rb = rat.to(F.dtype).abs()
        ra = 2.0 ** -22
    else:
        wt, cw = weights(rat, alpha, torch.bfloat16)
        bA = c * torch.einsum("urk,urm->ukm",
                              Fa * wt.to(F.dtype).abs()[..., None], Fa)
        rb = cw.to(F.dtype).abs()
        ra = 2.0 ** -21
        if base is not None:
            bA = bA + ra * base.to(F.dtype).abs()[None]
    if reg is not None:
        bA = bA + ra * _diag(reg, F).abs() * eye
    return bA, c * torch.einsum("urk,ur->uk", Fa, rb)


def fused_gram_f64_error(table: torch.Tensor, idx: torch.Tensor,
                         rat: torch.Tensor, reg, A: torch.Tensor,
                         b: torch.Tensor, *, alpha: Optional[float] = None,
                         base: Optional[torch.Tensor] = None):
    """(A's, b's) largest error against a float64 sum of the same
    products, entry by entry relative to |F|^T|F| + |reg| I and
    |F|^T|rat| (F = table[idx] widened); with ``alpha`` to |F|^T wt |F| +
    |base| + |reg| I and |F|^T |c|, the weights rounded as the kernel
    rounds them. A padding entity's entries are exact or count as
    infinitely wrong."""
    F = table[idx].double()
    Fa = F.abs()
    if alpha is None:
        wa, r = None, rat.double()
    else:
        wt, c = weights(rat, alpha, torch.bfloat16)
        wa, r = wt.double(), c.double()
    Fw = F if wa is None else F * wa[..., None]
    A64 = torch.einsum("urk,urm->ukm", Fw, F)
    sA = torch.einsum("urk,urm->ukm", Fw.abs(), Fa)
    if base is not None:
        A64 = A64 + base.double()[None]
        sA = sA + base.double().abs()[None]
    if reg is not None:
        eye = torch.eye(F.shape[-1], dtype=F.dtype, device=F.device)
        rg = _diag(reg, F)
        A64 = A64 + rg * eye
        sA = sA + rg.abs() * eye
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


def part_bytes_of(ne: int, s: int, w: int) -> int:
    """Bytes of partials that a call of ne entities cut into s > 1 parts
    moves at width w: each part's f32 A [w, w] and b [w], written once by
    the kernel and read once by the sum; 0 for s = 1."""
    return 0 if s == 1 else 2 * ne * s * (w * w + w) * 4


def fused_gram_cuda(table: torch.Tensor, idx: torch.Tensor,
                    rat: torch.Tensor, reg=None, *,
                    alpha: Optional[float] = None,
                    base: Optional[torch.Tensor] = None):
    """Launch the fused kernel on PyTorch's current stream.

    table [n, w] bf16 (w <= 256), idx [NE, R] int32/int64, rat [NE, R]
    bf16 -> (A [NE, w, w] f32, b [NE, w] f32). Plain mode: reg [NE] f32 or
    None. ``alpha`` selects the weighted mode (w <= ``NARROW_W``): reg one
    float or None, ``base`` [w, w] f32 the base Gram (symmetric) or None.
    """
    global launches, weighted_launches, split_launches, part_bytes
    dev = table.device
    ridge = 0.0  # the weighted mode's ridge
    if alpha is None:
        if base is not None or not (reg is None
                                    or isinstance(reg, torch.Tensor)):
            raise ValueError("fused_gram takes a base Gram or a float "
                             "ridge in the weighted mode only")
    else:
        if table.shape[-1] > NARROW_W:
            raise ValueError(f"fused_gram's weighted mode takes w <= "
                             f"{NARROW_W}, got w = {table.shape[-1]}")
        if isinstance(reg, torch.Tensor):
            raise TypeError("fused_gram's weighted mode takes one float "
                            "ridge, not a tensor")
        ridge, reg = (0.0 if reg is None else float(reg)), None
        if base is not None:
            w = table.shape[-1]
            if not (base.is_cuda and base.device == dev
                    and base.dtype == torch.float32
                    and base.shape == (w, w) and base.is_contiguous()):
                raise ValueError(f"fused_gram takes base [w, w] f32, "
                                 f"contiguous, on the table's device; got "
                                 f"{tuple(base.shape)} {base.dtype}")
            if base.data_ptr() % 16:
                base = base.clone()  # the epilogue reads 16 bytes at a time
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
    diag = reg[:, None] if reg is not None else ridge or None
    if ne == 0 or R == 0:
        A = torch.zeros(ne, w, w, dtype=torch.float32, device=dev)
        b = torch.zeros(ne, w, dtype=torch.float32, device=dev)
        return _finish(A, b, base, diag)
    if n == 0:
        raise IndexError("fused_gram: indices into an empty table")
    s, r_part = _parts(ne, R, fill_blocks(w))
    A = torch.empty(ne * s, w, w, dtype=torch.float32, device=dev)
    b = torch.empty(ne * s, w, dtype=torch.float32, device=dev)
    lib = _build.load_library()
    # base and ridge in the kernel with one part, else after the parts
    one = s == 1
    args = (table.data_ptr(), idx.data_ptr(), rat.data_ptr())
    tail = (A.data_ptr(), b.data_ptr(), ne, R, s, r_part, w, n,
            int(idx.dtype == torch.int64), _build.stream(dev))
    if alpha is None:
        rc = lib.ycnr_fused_gram(
            *args, reg.data_ptr() if reg is not None and one else None,
            *tail)
    else:
        rc = lib.ycnr_fused_gram_weighted(
            *args, *tail, base.data_ptr() if base is not None and one
            else None, float(alpha), ridge if one else 0.0)
    _build.check(rc, "ycnr_fused_gram")
    launches += 1
    if alpha is not None:
        weighted_launches += 1
    if one:
        return A, b
    split_launches += 1
    part_bytes += part_bytes_of(ne, s, w)
    # the same reduction order for every entry: A stays bit-symmetric; the
    # base Gram and the ridge go on once, after the parts are summed
    with span("part_sum"):
        return _finish(A.view(ne, s, w, w).sum(1), b.view(ne, s, w).sum(1),
                       base, diag)


def _finish(A, b, base, diag):
    """Summed partials + base, then the ridge (``diag``: reg [NE, 1], one
    float or None) on the diagonal, in place."""
    if base is not None:
        A.add_(base)
    if diag is not None:
        A.diagonal(dim1=1, dim2=2).add_(diag)
    return A, b


def fused_gram(table: torch.Tensor, idx: torch.Tensor, rat: torch.Tensor,
               reg=None, *,
               alpha: Optional[float] = None,
               base: Optional[torch.Tensor] = None):
    """(A, b) per entity: the plain version on the CPU, the kernel on
    CUDA. ``reg``: the ridge, a tensor [NE] (or None); ``alpha`` (iALS's
    confidence scale) selects the weighted mode, in which ``reg`` is one
    float and ``base`` the [w, w] f32 addend (module docstring)."""
    if table.device.type == "cpu":
        return fused_gram_reference(table, idx, rat, reg, alpha=alpha,
                                    base=base)
    return fused_gram_cuda(table, idx, rat, reg, alpha=alpha, base=base)

"""Out-of-core ALS-WR / iALS epochs (counterpart of
``ycnr_tpu/models/ooc.py``).

The resident path (``models/bucketed_phase.py``) keeps the whole decoded
rating layout on the device, ~10 bytes a slot (int64 index + bf16 or f32
rating) for both views. This module keeps only the factors resident and
the rating blocks in the compact wire form of ``ops/packed.py``, ~3 bytes
a slot or less, in one of two tiers per wire group:

* pinned: ``wire_to_device`` moves whole groups to the device (greedy,
  largest first, under a byte budget; a packed group is upgraded to the
  RECT wire when that fits, whose decode needs no per-slot gathers);
* streamed: the group stays in host memory (NumPy arrays or memmaps) and
  moves to the device every epoch in chunks of blocks (~48 MB of wire
  each) through ``ChunkStream``: a ring of ``prefetch + 1`` pinned host
  staging buffers, one side CUDA stream for the copies and one event per
  chunk that the compute stream waits on, so the next chunks move while
  the current one is solved.

Every block is decoded on the device with plain torch ops (the JAX
package runs its decode as plain XLA ops) back to the resident layout's
``(other_idx, rating)`` block, bit for bit, and solved by the resident
phase's own block step: the fused gather -> Gram kernel + K1 for bf16
ALS-WR on CUDA, the row-gather kernel + einsums + K1 otherwise. The
solved rows are written into the factor table in place, by entity id
(``E[eid] = rows``, the classic route ``train(ooc=True)`` runs) or at the
block's storage offset (``E[off:off + NE] = rows``, the wire-order
storage phase). So an OOC epoch equals the resident epoch bit for bit.

Not ported, because they exist for the TPU: the JAX package's
wire-ordered solve table ``Ep``, its per-phase assemble and their layout
pins (XLA's TPU scatter flips the factor table's layout), the jitted
bf16 cast, and the padding of a final chunk to one compiled shape (a
short last chunk is shipped as it is: nothing recompiles).

On the CPU (the tests) the same code runs with no stream: a group is
"resident" when its arrays are tensors (on whatever device) and "on the
host, streamed" when they are NumPy arrays, so both tiers and the mixed
epoch run there too.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch

from ycnr_tpu_torch import resolve_device
from ycnr_tpu_torch.models.base import MFState
from ycnr_tpu_torch.models.bucketed_phase import (
    bucket_finish_solve,
    bucket_fused_rows,
    bucket_normal_eq,
    bucket_solve_rows,
    fused_base,
    uses_fused,
)
from ycnr_tpu_torch.ops import fused_gram
from ycnr_tpu_torch.ops.packed import PackedCSR, rect_from_packed
from ycnr_tpu_torch.ops.row_gather import row_gather

# ----------------------------------------------------------- wire arrays ---

# unsigned wire columns travel as the signed type of their width (the same
# bits): torch's unsigned types beyond uint8 take few operators
_SIGNED = {np.dtype(np.uint16): np.dtype(np.int16),
           np.dtype(np.uint32): np.dtype(np.int32)}
_TORCH = {np.dtype(t): getattr(torch, t) for t in
          ("int8", "int16", "int32", "int64", "float32", "float64")}


def wire_tensor(a, device) -> torch.Tensor:
    """A host wire array (NumPy or memmap) as a tensor on ``device``,
    unsigned columns as the signed type of the same width."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(_SIGNED.get(a.dtype, a.dtype))).to(device)


def widen_u16(t: torch.Tensor) -> torch.Tensor:
    """uint16 wire bits (held as int16, or uint16) as int32."""
    return t.to(torch.int32) & 0xFFFF


def _row_cumsum(d, valid, n_other: int):
    """Row-wise prefix sums of the deltas d [..., R] (0 on padding slots)
    masked to n_other: one flat scan of the whole batch, less each row's
    sum before its start (exact in int64), which on CUDA is a device-wide
    scan instead of a scan per short row."""
    R = d.shape[-1]
    flat = torch.cumsum(d.reshape(-1), 0)
    rows = flat.view(-1, R)
    before = rows[:, :1] - d.reshape(-1, R)[:, :1]
    return torch.where(valid, (rows - before).view(d.shape), n_other)


def decode_blocks(lo, hi_pos, hi_val, rat, cnt, R: int, n_other: int,
                  dtype):
    """Packed wire blocks [C, ...] -> the resident layout's (oi [C, NE, R]
    int64, rr [C, NE, R] ``dtype``), all C blocks in one pass.

    Scatter the sparse high bits into the u16 delta stream (``index_add_``:
    exact on integers, and the (0, 0) padding entries add nothing however
    often they repeat), unpack the packed rows to the padded rectangle
    (gather by row start + column), then row-wise prefix sums rebuild the
    absolute ids (each row's first element is stored absolute). Padding
    slots are masked to n_other / rating 0, the zero-row contract.
    """
    C, S = lo.shape
    base = torch.arange(C, device=lo.device) * S
    delta = widen_u16(lo).view(-1)
    delta.index_add_(0, (hi_pos.long() + base[:, None]).view(-1),
                     (hi_val.to(torch.int32) * 65536).view(-1))
    cnt = cnt.long()
    starts = torch.cumsum(cnt, 1) - cnt + base[:, None]
    col = torch.arange(R, device=lo.device)
    valid = col < cnt[..., None]
    src = torch.where(valid, starts[..., None] + col, 0)
    d = torch.where(valid, delta[src], 0)
    return (_row_cumsum(d, valid, n_other),
            _ratings(rat.view(-1)[src], valid, dtype))


def decode_blocks_rect(lo, hi_pos, hi_val, rat, cnt, R: int, n_other: int,
                       dtype):
    """RECT wire blocks [C, NE, R] -> (oi [C, NE, R] int64, rr) with no
    per-slot gathers: one sparse add of the 16-bit overflow corrections,
    the row-wise prefix sums and the padding masks (padding slots carry
    delta 0). Bitwise the packed decode and the resident layout."""
    C, NE = cnt.shape
    delta = widen_u16(lo).view(-1)
    base = torch.arange(C, device=lo.device) * (NE * R)
    delta.index_add_(0, (hi_pos.long() + base[:, None]).view(-1),
                     (hi_val.to(torch.int32) * 65536).view(-1))
    valid = torch.arange(R, device=lo.device) < cnt.long()[..., None]
    return (_row_cumsum(delta.view(C, NE, R), valid, n_other),
            _ratings(rat, valid, dtype))


def decode_block(lo, hi_pos, hi_val, rat, cnt, R: int, n_other: int,
                 dtype):
    """One packed wire block -> (oi [NE, R] int64, rr [NE, R])."""
    oi, rr = decode_blocks(lo[None], hi_pos[None], hi_val[None], rat[None],
                           cnt[None], R, n_other, dtype)
    return oi[0], rr[0]


def decode_block_rect(lo, hi_pos, hi_val, rat, cnt, R: int, n_other: int,
                      dtype):
    """One RECT wire block -> (oi [NE, R] int64, rr [NE, R])."""
    oi, rr = decode_blocks_rect(lo[None], hi_pos[None], hi_val[None],
                                rat[None], cnt[None], R, n_other, dtype)
    return oi[0], rr[0]


def _ratings(rv, valid, dtype):
    """Wire ratings (int8 half-stars or raw f32) in ``dtype``, 0 on
    padding slots. int8 * 0.5 is exact in bf16, f32 and f64, so a bf16
    rating is the f32 rating rounded once, as the resident layout's."""
    rr = rv.to(dtype) * 0.5 if rv.dtype == torch.int8 else rv.to(dtype)
    return torch.where(valid, rr, 0)


# ------------------------------------------------------- the block step ---

# Cap on one block's gathered-rows tensor (F_g[oi]: [rows, R, k]) on the
# row-gather branch: blocks whose gather would exceed it solve in row
# sub-chunks, and blocks too skinny for that (few entities with very long
# lists) split the rating axis too and accumulate the Gram / RHS over the
# R-chunks. Row splits keep every entity's reduction whole (bitwise
# neutral); R splits reassociate its sum (~1e-15 in f64). The fused
# gather -> Gram kernel never materializes that tensor, so fused blocks
# run whole: a row split would change how the kernel splits long lists
# (``ops/fused_gram._parts``) and with it the rounding.
_GATHER_CHUNK_BYTES = 256 * 2**20


def _row_split(NE: int, R: int, k: int, itemsize: int) -> int:
    """Sub-chunk count over a block's rows (1 = whole). A sub-chunk keeps
    at least two rows (the JAX package's goes down to one): torch reduces
    a batch of one matrix-vector product (``bucket_normal_eq``'s
    right-hand side) in another order than a batch of several, so a
    one-row sub-chunk would change the bits."""
    s = 1
    while (NE % (2 * s) == 0 and NE // (2 * s) >= 2 and s < 64
           and (NE // s) * R * k * itemsize > _GATHER_CHUNK_BYTES):
        s *= 2
    return s


def _split_plan(NE: int, R: int, k: int, itemsize: int):
    """(s_ne, s_r) sub-chunk counts bounding one block's gathered tensor
    near _GATHER_CHUNK_BYTES: rows first, then the rating axis."""
    s_ne = _row_split(NE, R, k, itemsize)
    s_r = 1
    while (R % (2 * s_r) == 0 and s_r < 4096
           and (NE // s_ne) * (R // s_r) * k * itemsize
           > _GATHER_CHUNK_BYTES):
        s_r *= 2
    return s_ne, s_r


def _gather_solve(F_g, oi, rr, cntf, base_gram, lam, alpha, acc_t,
                  gather_bf16):
    """Row gather -> normal equations -> solved rows, sub-chunked as
    ``_split_plan`` says."""
    NE, R = oi.shape
    s, sr = _split_plan(NE, R, F_g.shape[1], F_g.element_size())
    if s == 1 and sr == 1:
        return bucket_solve_rows(F_g, oi, rr, cntf, lam, alpha, base_gram,
                                 acc_t, gather_bf16)
    q, qr = NE // s, R // sr
    k = F_g.shape[1]
    out = []
    for a in range(0, NE, q):
        soi, srr, scnt = oi[a:a + q], rr[a:a + q], cntf[a:a + q]
        if sr == 1:
            out.append(bucket_solve_rows(F_g, soi, srr, scnt, lam, alpha,
                                         base_gram, acc_t, gather_bf16))
            continue
        A = torch.zeros(q, k, k, dtype=acc_t, device=oi.device)
        b = torch.zeros(q, k, dtype=acc_t, device=oi.device)
        for c in range(0, R, qr):
            dA, db = bucket_normal_eq(
                row_gather(F_g, soi[:, c:c + qr].contiguous()),
                srr[:, c:c + qr], alpha, acc_t, gather_bf16)
            A, b = A + dA, b + db
        out.append(bucket_finish_solve(A, b, scnt, lam, alpha, base_gram))
    return torch.cat(out)


def gather_normal_eq(F_g, oi, rr, alpha, acc_t, gather_bf16):
    """Row gather -> per-entity normal equations (no base Gram, no ridge)
    of one block, sub-chunked as ``_split_plan`` says: the rating axis
    parts summed, the row parts concatenated."""
    NE, R = oi.shape
    s, sr = _split_plan(NE, R, F_g.shape[1], F_g.element_size())
    q, qr = NE // s, R // sr
    As, bs = [], []
    for a in range(0, NE, q):
        A = b = None
        for c in range(0, R, qr):
            dA, db = bucket_normal_eq(
                row_gather(F_g, oi[a:a + q, c:c + qr].contiguous()),
                rr[a:a + q, c:c + qr], alpha, acc_t, gather_bf16)
            A, b = (dA, db) if A is None else (A + dA, b + db)
        As.append(A)
        bs.append(b)
    return (As[0], bs[0]) if s == 1 else (torch.cat(As), torch.cat(bs))


# Decoded slots per decode batch: the blocks of a chunk are decoded
# together, a batch of consecutive blocks at a time (fewer and larger
# launches than a decode per block), which bounds the decode's temps
# (~48 bytes a slot) near 200 MB.
_DECODE_SLOTS = 1 << 22


def _decode_per(NE: int, R: int) -> int:
    """Blocks per decode batch for blocks of NE x R slots."""
    return max(1, _DECODE_SLOTS // max(1, NE * R))


# ---------------------------------------------------- the streaming tier ---

# wire bytes per streamed chunk, as the JAX package's: large enough that a
# copy's fixed costs vanish, small enough that prefetch + 1 chunks in
# flight stay small against the factors
_CHUNK_TARGET_BYTES = 48 * 2**20
_ALIGN = 256  # byte alignment of each array inside a staged chunk

staged_bytes = 0  # host bytes staged for the device since the last reset


class ChunkStream:
    """Host chunks to the device ahead of the compute.

    ``put`` hands a chunk's host arrays (rows of NumPy arrays or memmaps, a
    slice or an index array each) to a staging thread (one per chunk in
    flight), which copies them
    into the next of ``prefetch + 1`` staging buffers (one byte buffer per
    chunk, every array at an aligned offset; NumPy's copies release the
    interpreter lock, so this overlaps the caller's launches) and on CUDA
    issues one host-to-device copy of it on a side stream (``non_blocking``,
    from pinned memory) and records an event. ``take`` waits for the
    staging, makes the compute stream wait for that event and returns the
    chunk's arrays as tensors. A staging buffer is rewritten only after the
    copy out of it has finished (its event), and a chunk's device buffer,
    made on the side stream, is marked as used by the compute stream
    (``record_stream``), so the allocator does not hand it to the next copy
    while the compute stream still reads it.

    On the CPU there is no copy and no stream: the chunk's tensors are
    views of the staging buffer, which is rewritten only for the chunk
    ``prefetch + 1`` places later, after the caller has moved past this
    one (``stream_chunks`` stages at most ``prefetch`` chunks ahead).
    Use it as a context manager: leaving it joins the staging thread.
    """

    def __init__(self, device, prefetch: int = 2):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.side = torch.cuda.Stream(self.device) if self.cuda else None
        self.bufs = [None] * (prefetch + 1)
        self.events = [None] * (prefetch + 1)
        self.k = 0
        # one staging thread per chunk in flight: chunks stage into
        # distinct buffers, so they copy side by side
        self.pool = ThreadPoolExecutor(max_workers=max(1, prefetch),
                                       thread_name_prefix="ycnr-stage")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.pool.shutdown(wait=True)

    def put(self, arrays, idx):
        """Stage rows ``idx`` (a slice, or an int array of rows to
        gather) of every host array; returns a handle for ``take``."""
        parts, total = [], 0
        for a in arrays:
            n = (len(range(*idx.indices(a.shape[0])))
                 if isinstance(idx, slice) else len(idx))
            shape = (n,) + tuple(a.shape[1:])
            nbytes = int(np.prod(shape, dtype=np.int64)) * a.dtype.itemsize
            parts.append((a, shape, total, nbytes))
            total += -(-nbytes // _ALIGN) * _ALIGN
        slot = self.k % len(self.bufs)
        self.k += 1
        return self.pool.submit(self._stage, parts, idx, total, slot), \
            parts, total

    def _stage(self, parts, idx, total, slot):
        """On the staging thread: fill the slot's buffer, then (CUDA) copy
        it to a new device buffer on the side stream. Returns the buffer
        holding the chunk and the copy's event."""
        if self.events[slot] is not None:
            self.events[slot].synchronize()  # its last copy has finished
        buf = self.bufs[slot]
        if buf is None or buf.numel() < total:
            buf = torch.empty(total, dtype=torch.uint8, pin_memory=self.cuda)
            self.bufs[slot] = buf
        host = buf.numpy()
        for a, shape, off, nbytes in parts:
            if isinstance(idx, slice):
                # as flat bytes: NumPy releases the interpreter lock for a
                # copy only when its outer dimension is long
                np.copyto(host[off:off + nbytes],
                          a[idx].reshape(-1).view(np.uint8))
            else:
                np.take(a, idx, axis=0, out=host[off:off + nbytes]
                        .view(a.dtype).reshape(shape))
        if not self.cuda:
            return buf, None
        with torch.cuda.device(self.device), torch.cuda.stream(self.side):
            dev = torch.empty(total, dtype=torch.uint8, device=self.device)
            dev.copy_(buf[:total], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.side)
        self.events[slot] = ev
        return dev, ev

    def take(self, handle):
        """The staged chunk's arrays as tensors, ready on the compute
        stream."""
        global staged_bytes
        fut, parts, total = handle
        if fut is None:  # a resident chunk: its tensors as they are
            return parts
        buf, ev = fut.result()
        staged_bytes += total
        if ev is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(ev)
            buf.record_stream(compute)
        out = []
        for a, shape, off, nbytes in parts:
            dt = _TORCH[_SIGNED.get(a.dtype, a.dtype)]
            out.append(buf[off:off + nbytes].view(dt).view(shape))
        return out


def stream_chunks(stream: ChunkStream, chunks, prefetch: int):
    """Yield ``(key, tensors)`` for each ``(key, arrays, idx)`` of
    ``chunks``, in order: rows ``idx`` of the host arrays, staged through
    ``stream`` ``prefetch`` chunks ahead of the one yielded; where
    ``arrays`` is None, ``idx`` is the chunk's tensors already."""
    q = []
    for key, arrays, idx in chunks:
        q.append((key, (None, idx, 0) if arrays is None
                  else stream.put(arrays, idx)))
        if len(q) > prefetch:
            key0, h = q.pop(0)
            yield key0, stream.take(h)
    for key0, h in q:
        yield key0, stream.take(h)


_WIRE_NAMES = ("lo", "hi_pos", "hi_val", "rat", "cnt", "eid")


def _chunk_blocks(g, chunk_blocks: Optional[int]) -> int:
    """Blocks per streamed chunk: ``chunk_blocks``, else ~48 MB of wire."""
    nb = g.n_blocks
    if chunk_blocks is None:
        per_block = max(1, sum(getattr(g, n).nbytes
                               for n in _WIRE_NAMES) // nb)
        chunk_blocks = int(_CHUNK_TARGET_BYTES // per_block)
    return max(1, min(nb, chunk_blocks))


def _wire_chunks(groups, stream: ChunkStream, chunk_blocks, prefetch: int):
    """Yield ((group index, first block), [C, ...] wire tensors) for every
    chunk of every group, in order: a resident group whole, a host group
    in chunks of ``_chunk_blocks`` blocks (the last one short) staged
    through ``stream``, ``prefetch`` chunks ahead across groups."""
    def chunks():
        for gi, g in enumerate(groups):
            if group_resident(g):
                yield (gi, 0), None, [getattr(g, n) for n in _WIRE_NAMES]
                continue
            C = _chunk_blocks(g, chunk_blocks)
            arrays = [getattr(g, n) for n in _WIRE_NAMES]
            for c0 in range(0, g.n_blocks, C):
                yield (gi, c0), arrays, slice(c0, c0 + C)

    yield from stream_chunks(stream, chunks(), prefetch)


# ------------------------------------------------------------ the phases ---

# Phase-wide bf16 gather copies above this size are skipped (the phase
# gathers in the factor dtype instead), as in the JAX package. The rule
# changes the numbers, not only the memory, so it is kept for parity; its
# size was chosen for a 15 GB accelerator (ROADMAP.md).
_BF16_COPY_MAX_BYTES = 512 * 2**20


def _phase_bf16(F, gather_bf16: bool) -> bool:
    return bool(gather_bf16) and \
        F.numel() * 2 <= _BF16_COPY_MAX_BYTES


def decoded_blocks(groups, device, rdt, cnt_dtype, prefetch: int,
                   chunk_blocks):
    """Yield ``(group index, block index, oi [NE, R] int64, rr [NE, R]
    rdt, cnt [NE] cnt_dtype, eid [NE] int64)`` for every block of the wire
    groups, in order: ``_wire_chunks``' walk (a resident group whole, a
    host group streamed in chunks), each chunk decoded in batches of
    ``_decode_per`` blocks."""
    with ChunkStream(device, prefetch) as stream:
        for (gi, c0), ch in _wire_chunks(groups, stream, chunk_blocks,
                                         prefetch):
            g = groups[gi]
            per = _decode_per(g.cnt.shape[1], g.R)
            for j0 in range(0, ch[0].shape[0], per):
                lo, hi_pos, hi_val, rat, cnt, eid = (a[j0:j0 + per]
                                                     for a in ch)
                dec = decode_blocks_rect if lo.dim() == 3 else decode_blocks
                oi, rr = dec(lo, hi_pos, hi_val, rat, cnt, g.R, g.n_other,
                             rdt)
                cntf, eid = cnt.to(cnt_dtype), eid.long()
                for j in range(oi.shape[0]):
                    yield gi, c0 + j0 + j, oi[j], rr[j], cntf[j], eid[j]


def block_rows(F_g, oi, rr, cntf, lam, alpha, base_gram, dtype,
               gather_bf16: bool, fused: bool) -> torch.Tensor:
    """One decoded block's solved rows in ``dtype``: the resident phase's
    block step (``phase_bucketed``). On the fused branch ``base_gram`` is
    the phase's ``fused_base``."""
    rows = (bucket_fused_rows(F_g, oi, rr, cntf, lam, alpha, base_gram)
            if fused else
            _gather_solve(F_g, oi, rr, cntf, base_gram, lam, alpha, dtype,
                          gather_bf16))
    return rows.to(dtype)


def _phase(E, F, groups, lam, alpha, base_gram, gather_bf16: bool,
           prefetch: int, chunk_blocks, offs=None):
    """Re-solve E's rows against F from wire groups, in place. Rows go to
    ``E[eid]`` or, with ``offs`` (per group, per block), to
    ``E[off:off + NE]``."""
    gather_bf16 = _phase_bf16(F, gather_bf16)
    F_g = F.to(torch.bfloat16) if gather_bf16 else F
    fused = uses_fused(E.device, E.dtype, alpha, gather_bf16, E.shape[1])
    rdt = torch.bfloat16 if fused else E.dtype
    if fused:
        base_gram = fused_base(base_gram)
    for gi, b, oi, rr, cntf, eid in decoded_blocks(
            groups, E.device, rdt, E.dtype, prefetch, chunk_blocks):
        rows = block_rows(F_g, oi, rr, cntf, lam, alpha, base_gram, E.dtype,
                          gather_bf16, fused)
        if offs is None:
            E[eid] = rows
        else:
            E[offs[gi][b]:offs[gi][b] + oi.shape[0]] = rows
    return E


def phase_packed(E: torch.Tensor, F: torch.Tensor, groups: PackedCSR,
                 lam: float, alpha: Optional[float] = None,
                 base_gram=None, gather_bf16: bool = False,
                 prefetch: int = 2,
                 chunk_blocks: Optional[int] = None) -> torch.Tensor:
    """Re-solve all entity rows of E against F from the wire format, in
    place (returns E).

    Per group: a group pinned on the device (``wire_to_device``) is walked
    block by block with no host traffic; a host group streams in chunks
    of ``chunk_blocks`` blocks (default ~48 MB of wire) with ``prefetch``
    chunks in flight. Each block's solved rows are written to ``E[eid]``;
    padding entities write the trash row with exact zeros, and cold
    entities (in no block) keep their values.

    ``gather_bf16`` holds only while F's bf16 copy stays under
    _BF16_COPY_MAX_BYTES; beyond it the phase gathers in F's dtype.
    """
    return _phase(E, F, groups, lam, alpha, base_gram, gather_bf16,
                  prefetch, chunk_blocks)


def als_epoch_ooc(state: MFState, user_groups: PackedCSR,
                  item_groups: PackedCSR, lam: float,
                  gather_bf16: bool = False, prefetch: int = 2,
                  chunk_blocks: Optional[int] = None) -> MFState:
    """One ALS-WR sweep over wire groups (pinned, streamed or mixed): the
    math of ``bucketed_phase.als_epoch_fn``. Updates the state's factors
    in place."""
    U = phase_packed(state.U, state.V, user_groups, lam,
                     gather_bf16=gather_bf16, prefetch=prefetch,
                     chunk_blocks=chunk_blocks)
    V = phase_packed(state.V, U, item_groups, lam,
                     gather_bf16=gather_bf16, prefetch=prefetch,
                     chunk_blocks=chunk_blocks)
    return state._replace(U=U, V=V)


def ials_epoch_ooc(state: MFState, user_groups: PackedCSR,
                   item_groups: PackedCSR, lam: float, alpha: float,
                   gather_bf16: bool = False, prefetch: int = 2,
                   chunk_blocks: Optional[int] = None) -> MFState:
    """One iALS sweep over wire groups; the global base Gram is taken per
    phase from the resident factors, as the resident path does."""
    U = phase_packed(state.U, state.V, user_groups, lam, alpha,
                     state.V.T @ state.V, gather_bf16=gather_bf16,
                     prefetch=prefetch, chunk_blocks=chunk_blocks)
    V = phase_packed(state.V, U, item_groups, lam, alpha, U.T @ U,
                     gather_bf16=gather_bf16, prefetch=prefetch,
                     chunk_blocks=chunk_blocks)
    return state._replace(U=U, V=V)


# --------------------------------------------------- wire-order storage ---

class DeviceWirePlan:
    """What a wire-order storage phase needs of a ``WireStoragePlan``: the
    per-group block offsets, as host ints (a block's rows are a slice of
    the table). The JAX package's also carries the scratch region that
    its chunk-pad blocks write; the port ships no pad blocks. ``perm``
    stays with the plan; it maps eval COOs and checkpoints, never the
    epoch."""

    __slots__ = ("offs",)

    def __init__(self, plan):
        self.offs = tuple(np.asarray(o, np.int64).tolist()
                          for o in plan.offs)


def phase_packed_wire(E: torch.Tensor, F: torch.Tensor, groups: PackedCSR,
                      lam: float, plan: DeviceWirePlan,
                      alpha: Optional[float] = None, base_gram=None,
                      gather_bf16: bool = False, prefetch: int = 2,
                      chunk_blocks: Optional[int] = None) -> torch.Tensor:
    """Wire-order storage phase: E IS the wire-ordered factor table.

    The block step of ``phase_packed``, writing each block's rows at its
    storage offset (``E[off:off + NE]``). The wire was built with
    ``other_plan`` (``ops/packed.build_packed``), so its indices are F's
    storage rows and its decode sentinel is F's zero row. Cold entities
    and the scratch / zero tail are never written and keep their values.
    """
    return _phase(E, F, groups, lam, alpha, base_gram, gather_bf16,
                  prefetch, chunk_blocks, offs=plan.offs)


def als_epoch_wire(U: torch.Tensor, V: torch.Tensor, user_groups: PackedCSR,
                   item_groups: PackedCSR, lam: float,
                   u_plan: DeviceWirePlan, i_plan: DeviceWirePlan,
                   gather_bf16: bool = False, prefetch: int = 2,
                   chunk_blocks: Optional[int] = None):
    """One ALS-WR sweep over wire-order storage tables (in place)."""
    U = phase_packed_wire(U, V, user_groups, lam, u_plan,
                          gather_bf16=gather_bf16, prefetch=prefetch,
                          chunk_blocks=chunk_blocks)
    V = phase_packed_wire(V, U, item_groups, lam, i_plan,
                          gather_bf16=gather_bf16, prefetch=prefetch,
                          chunk_blocks=chunk_blocks)
    return U, V


def ials_epoch_wire(U: torch.Tensor, V: torch.Tensor,
                    user_groups: PackedCSR, item_groups: PackedCSR,
                    lam: float, alpha: float, u_plan: DeviceWirePlan,
                    i_plan: DeviceWirePlan, gather_bf16: bool = False,
                    prefetch: int = 2,
                    chunk_blocks: Optional[int] = None):
    """iALS sweep over wire-order storage tables. The base Grams are the
    full tables' (padding / scratch / zero rows are zero)."""
    U = phase_packed_wire(U, V, user_groups, lam, u_plan, alpha, V.T @ V,
                          gather_bf16=gather_bf16, prefetch=prefetch,
                          chunk_blocks=chunk_blocks)
    V = phase_packed_wire(V, U, item_groups, lam, i_plan, alpha, U.T @ U,
                          gather_bf16=gather_bf16, prefetch=prefetch,
                          chunk_blocks=chunk_blocks)
    return U, V


def wire_storage_init(plan, rank: int, seed: int, entity_offset: int = 0,
                      scale: float = 0.1, dtype=torch.float32, device=None):
    """Storage-ordered init table equal to ``init_state``'s rows
    permuted: row perm[e] gets exactly the value ``init_state`` gives
    entity e (the same NumPy draws; ``entity_offset`` skips the draws of
    the views before this one, in bounded chunks). Tail rows start zero.
    ``device`` None means the card (``resolve_device``)."""
    device = resolve_device(device, "wire_storage_init()")
    rng = np.random.default_rng(seed)
    burn_chunk = 1 << 20
    for a in range(0, entity_offset, burn_chunk):
        rng.normal(0.0, scale, (min(burn_chunk, entity_offset - a), rank))
    vals = rng.normal(0.0, scale, (len(plan.perm), rank))
    tab = np.zeros((plan.table_rows, rank), np.float64)
    tab[plan.perm] = vals
    return torch.tensor(tab, dtype=dtype, device=device)


# ------------------------------------------------------------ evaluation ---

def rmse_wire(state: MFState, user_groups: PackedCSR, nnz: int,
              chunk_blocks: Optional[int] = None, gather_bf16: bool = True,
              prefetch: int = 2) -> float:
    """Train RMSE straight from the wire (one view covers every rating
    once). Errors are f32, as the JAX package's; their squares are summed
    in float64 on the device per chunk and across chunks on the host (the
    JAX package sums each chunk in f32, in an order that then depends on
    the sub-chunk split). ``gather_bf16=False`` predicts in the factors'
    dtype."""
    E, F = state.U, state.V
    gdt = torch.bfloat16 if gather_bf16 else E.dtype
    pdt = torch.float32 if gather_bf16 else E.dtype
    acc = 0.0
    with ChunkStream(E.device, prefetch) as stream:
        for (gi, _), ch in _wire_chunks(user_groups, stream, chunk_blocks,
                                        prefetch):
            acc += _sq_err_chunk(E, F, user_groups[gi], ch, gdt, pdt)
    return (acc / max(nnz, 1)) ** 0.5


def _sq_err_chunk(E, F, g, ch, gdt, pdt) -> float:
    """rmse_wire's sum of squared errors over one chunk of group g, summed
    in float64 on the device."""
    NE, R = g.cnt.shape[1], g.R
    s, sr = _split_plan(NE, R, F.shape[1], torch.finfo(gdt).bits // 8)
    q, qr = NE // s, R // sr
    per = _decode_per(NE, R)
    total = torch.zeros((), dtype=torch.float64, device=E.device)
    for j0 in range(0, ch[0].shape[0], per):
        lo, hp, hv, rat, cnt, eid = (a[j0:j0 + per] for a in ch)
        dec = decode_blocks_rect if lo.dim() == 3 else decode_blocks
        ois, rrs = dec(lo, hp, hv, rat, cnt, R, g.n_other, torch.float32)
        for oi, rr, bid, bcnt in zip(ois, rrs, eid.long(), cnt.long()):
            for a in range(0, NE, q):
                Er = row_gather(E, bid[a:a + q]).to(gdt).to(pdt)
                for c in range(0, R, qr):
                    soi = oi[a:a + q, c:c + qr].contiguous()
                    Fr = row_gather(F, soi).to(gdt).to(pdt)
                    pred = torch.einsum("urk,uk->ur", Fr, Er).float()
                    valid = (c + torch.arange(qr, device=E.device)
                             < bcnt[a:a + q, None])
                    err = torch.where(valid, rr[a:a + q, c:c + qr] - pred,
                                      0.0).double()
                    total = total + (err * err).sum()
    return float(total)


# ------------------------------------------------------ residency policy ---

def wire_nbytes(*group_tuples) -> int:
    """Total wire bytes across any number of PackedCSR/RectCSR tuples."""
    return sum(getattr(g, n).nbytes
               for gs in group_tuples for g in gs for n in _WIRE_NAMES)


def group_resident(g) -> bool:
    """True when g's wire arrays are tensors (pinned on a device), False
    when they are host NumPy arrays or memmaps (streamed)."""
    return isinstance(g.lo, torch.Tensor)


def device_hbm_stats(device=None) -> dict:
    """The card's memory in the JAX package's keys: ``bytes_in_use`` and
    ``peak_bytes_in_use`` (PyTorch's allocator) and ``bytes_limit`` (the
    card's size). ``device`` None means the card if there is one; {} on
    the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = "cuda"
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    ms = torch.cuda.memory_stats(device)
    return {"bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.mem_get_info(device)[1])}


# where no device reports a size (the CPU), the JAX package's assumption
_NO_LIMIT_BYTES = 15 * 10**9


def device_hbm_bytes(device=None) -> int:
    """The card's size in bytes (``device_hbm_stats``), or 15 GB where
    there is none to read."""
    return device_hbm_stats(device).get("bytes_limit", _NO_LIMIT_BYTES)


def _block_working_set(g, k: int, gather_isz: int) -> int:
    """Device bytes one block of g holds while it is decoded and solved,
    the larger of the two branches: ~48 B per slot of its decode batch's
    temps (indices, masks, prefix sums, ratings), plus on the row-gather
    branch the gathered rows (capped by _split_plan) and ~4 copies of the
    [q, k, k] normal equations, on the fused branch the kernel's parts of
    A (split for the body that runs at k, ``fused_gram.fill_blocks``),
    their sum and the solve's copy."""
    NE, R = int(g.cnt.shape[1]), int(g.R)
    decode = 48 * NE * R * min(_decode_per(NE, R), g.n_blocks)
    s, sr = _split_plan(NE, R, k, gather_isz)
    gathered = (NE // s) * (R // sr) * k * gather_isz \
        + 4 * (NE // s) * k * k * 4
    parts = fused_gram._parts(NE, R, fused_gram.fill_blocks(k))[0] if R \
        else 1
    fused = (parts + 2) * NE * k * k * 4
    return decode + max(gathered, fused)


def auto_wire_budget(n_users: int, n_items: int, rank: int,
                     hbm_bytes: Optional[int] = None, groups=(),
                     storage: str = "entity",
                     table_rows: Optional[Tuple[int, int]] = None,
                     prefetch: int = 2, device=None) -> int:
    """Device bytes available for pinning wire groups.

    Starts from the card's size (``device_hbm_stats``; ``hbm_bytes`` fixes
    it) and reserves what an epoch really holds beside the pinned wire:
    the f32 factors and biases, the phase's bf16 gather copy (one phase's
    at a time, under _BF16_COPY_MAX_BYTES), the largest block's working
    set (``_block_working_set``, from ``groups`` when given, else 1.5 GB),
    ``prefetch + 1`` streamed chunks on the device, and a 1 GB margin. The
    JAX package also reserves a wire-ordered solve table twice and a
    128-lane padded eval copy; the port holds neither.

    ``storage="wire"`` (``phase_packed_wire``) sizes the factors from
    ``table_rows`` (the two ``WireStoragePlan.table_rows``; n + 2% + 2
    when not given)."""
    if hbm_bytes is None:
        hbm_bytes = device_hbm_bytes(device)
    k = rank
    if storage == "wire":
        if table_rows is None:
            table_rows = (int(n_users * 1.02) + 2, int(n_items * 1.02) + 2)
        n_users, n_items = table_rows
    bf16 = {n: (n * k * 2 if n * k * 2 <= _BF16_COPY_MAX_BYTES else 0)
            for n in (n_users + 1, n_items + 1)}
    chunk = _CHUNK_TARGET_BYTES
    if groups:
        inflight = 0
        # view 0 (user rows) gathers the item factor and vice versa
        for gr, n_f in zip(groups, (n_items + 1, n_users + 1)):
            isz = 2 if bf16[n_f] else 4
            for g in gr:
                inflight = max(inflight, _block_working_set(g, k, isz))
                per_block = sum(getattr(g, n).nbytes
                                for n in _WIRE_NAMES) // g.n_blocks
                chunk = max(chunk, per_block * _chunk_blocks(g, None))
    else:
        inflight = 1_500_000_000
    reserve = ((n_users + n_items + 2) * (k + 1) * 4     # f32 factors+biases
               + max(bf16.values())                    # the phase's copy
               + inflight
               + (prefetch + 1) * chunk                # streamed chunks
               + 1_000_000_000)
    return max(0, hbm_bytes - reserve)


def _rect_bytes_estimate(g) -> int:
    """Upper bound on g's wire bytes after rect_from_packed (exact for
    lo/rat/cnt/eid; hi uses the packed H, which conversion can only
    shrink)."""
    if g.lo.ndim == 3:  # already rect
        return sum(getattr(g, n).nbytes for n in _WIRE_NAMES)
    nb, ne = g.cnt.shape
    slot = 2 + g.rat.itemsize  # u16 delta + rating
    return (nb * ne * g.R * slot + g.hi_pos.nbytes + g.hi_val.nbytes
            + g.cnt.nbytes + g.eid.nbytes)


def wire_to_device(user_groups, item_groups,
                   budget_bytes: Optional[int] = None,
                   pin_format: str = "auto", device=None):
    """Pin wire groups on ``device`` (None: the card, ``resolve_device``)
    so epochs skip the host wire.

    Greedy largest-first whole-group placement under ``budget_bytes``
    (None = pin everything; a device too small for that raises, it never
    streams quietly); groups that don't fit keep their host arrays and
    stream, and ``phase_packed`` dispatches per group.

      "auto"  pin as RECT (gather-free decode, 1/fill more bytes) when
              the budget allows, else pin the group PACKED when only that
              fits, else stream it
      "keep"  pin groups in the format they arrived in

    Returns (user_groups, item_groups, resident_bytes)."""
    device = resolve_device(device, "wire_to_device()")
    tagged = ([("u", i, g) for i, g in enumerate(user_groups)]
              + [("i", i, g) for i, g in enumerate(item_groups)])
    sizes = {(s, i): sum(getattr(g, n).nbytes for n in _WIRE_NAMES)
             for s, i, g in tagged}
    out = {"u": list(user_groups), "i": list(item_groups)}
    spent = 0

    def pin(g):
        return g._replace(**{n: wire_tensor(getattr(g, n), device)
                             for n in _WIRE_NAMES})

    for s, i, g in sorted(tagged, key=lambda t: -sizes[(t[0], t[1])]):
        b = sizes[(s, i)]
        if group_resident(g):
            spent += b
            continue
        rb = _rect_bytes_estimate(g) if pin_format == "auto" else None
        if (pin_format == "auto" and g.lo.ndim != 3
                and (budget_bytes is None or spent + rb <= budget_bytes)):
            rg = rect_from_packed(g)
            out[s][i] = pin(rg)
            spent += sum(getattr(rg, n).nbytes for n in _WIRE_NAMES)
            continue
        if budget_bytes is not None and spent + b > budget_bytes:
            continue
        out[s][i] = pin(g)
        spent += b
    return tuple(out["u"]), tuple(out["i"]), spent

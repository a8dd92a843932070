"""Compact wire format for the stream-SGD layout (the port's copy of
``ycnr_tpu/ops/sgd_wire.py``: the host code is the original's and gives
the same arrays bit for bit, ``tests/test_torch_host_copies.py``; pinning
and the budget are on torch).

The flat stream (``models/sgd_stream.StreamSGDData``) costs ~20 B/rating
(ul/ib int32 + rb/wu/wi f32). This module encodes the same stream
compactly; its decode (``models/sgd_stream._decode_compact_batch``) runs
once per batch ahead of the batch update.

Per [NB, B] stream row (vs the flat 20 B):

* ``ul``     uint16 — the tile-LOCAL user row (the tile property of the
  stream layout makes user ids small by construction). Streams whose
  tile exceeds 65,536 ride uint32 local rows instead;
* ``ilo``    uint16 — low bits of the within-batch item-id delta (items
  are sorted per batch by the stream builder, so deltas are small
  ascending ints; element 0 of each batch carries the absolute id) plus
  a sparse (position, high-bits) overflow side-channel — the exact
  scheme of ops/packed.py:_encode_rows, exact for any catalog size;
* ``rq``     int8 half-stars when exactly representable (the
  ops/packed.rating_wire_kind rule; int8*0.5 is exact in f32/f64), else
  raw float32;
* ``mu``/``mi`` uint16 — within-batch user/item multiplicity MINUS ONE.
  The "mean"/"capped" update weights depend only on (multiplicity, cap),
  so they are recomputed on the device by the same formula the flat
  builder used instead of shipping 8 B/rating of f32 weights. "sum" mode
  needs no multiplicities; they ship as [NB, 1] zeros.

Total: 9 B/rating ("half" ratings, capped/mean) or 5 B ("sum").

The same arrays serve both out-of-core tiers: pinned whole in device
memory (``put_compact``; ``sgd_stream.sgd_stream_epoch_pinned``) or kept
on the host and streamed in chunks (``sgd_stream._compact_epoch_ooc``);
``models/sgd_stream.StreamSGD.epoch`` dispatches on (format, residency).
A pinned wire holds torch tensors, with the unsigned columns as the
signed type of the same width (the same bits); the decode widens them.

Parity: decode is validated on build (decode_compact == the flat
stream's arrays; weights bitwise on the host), and the pinned/streamed
epochs share the flat epoch's batch-update body, so float64 epoch
parity is bitwise.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import torch

from ycnr_tpu_torch import resolve_device
from ycnr_tpu_torch.models.ooc import device_hbm_bytes, wire_tensor
from ycnr_tpu_torch.ops.packed import rating_wire_kind


class CompactStreamSGD(NamedTuple):
    """Compact stream in wire form. Arrays are numpy on the host
    (streamable) or torch tensors (pinned) — ``put_compact`` moves them;
    the epoch dispatch in models/sgd_stream.StreamSGD keys on the array
    type."""

    ul: np.ndarray       # [NB, B] uint16 tile-local user row (uint32
    #                      when tile > 65,536)
    ilo: np.ndarray      # [NB, B] uint16 item-delta low bits
    ihi_pos: np.ndarray  # [NB, H] int32 within-batch overflow positions
    ihi_val: np.ndarray  # [NB, H] int32 delta >> 16 (padding: (0, 0) —
    #                      a scatter-add no-op, as in ops/packed.py)
    rq: np.ndarray       # [NB, B] int8 ("half") | float32 ("raw")
    mu: np.ndarray       # [NB, B] uint16 user multiplicity - 1
    #                      ([NB, 1] zeros for grad_mode="sum")
    mi: np.ndarray       # [NB, B] uint16 item multiplicity - 1 (ditto)
    u_lo: np.ndarray     # [NB] int32 tile start row
    tile: int
    cap: int
    grad_mode: str
    rating_kind: str     # "half" | "raw"
    n_items: int
    n_real: int

    @property
    def nbytes(self) -> int:
        return sum(getattr(self, n).nbytes for n in
                   ("ul", "ilo", "ihi_pos", "ihi_val", "rq", "mu", "mi",
                    "u_lo"))


def _run_lengths_sorted(keys: np.ndarray, batch: int) -> np.ndarray:
    """Multiplicity per element for batch-sorted keys (runs break at
    batch boundaries) — the ops/sgd_stream._run_multiplicity scheme."""
    brk = np.empty(len(keys), np.bool_)
    brk[0] = True
    np.not_equal(keys[1:], keys[:-1], out=brk[1:])
    brk[::batch] = True
    starts = np.flatnonzero(brk)
    lens = np.diff(np.r_[starts, len(keys)]).astype(np.int64)
    return np.repeat(lens, lens)


def compact_from_stream(data, n_items: int, cap: int = 32,
                        validate: bool = True) -> CompactStreamSGD:
    """Convert a HOST flat stream (prepare_stream_sgd(device=False)) to
    the compact wire. ``cap`` must match the prepare call's (default 32);
    ``validate`` re-decodes on host and asserts exact equality with the
    flat arrays — weights included — so a mismatch is loud, not silent.

    Raises ValueError when the layout can't encode compactly (batch
    beyond u16 multiplicities, or float64 ratings that don't fit the
    f32 raw wire); callers fall back to the flat stream.
    """
    ul = np.asarray(data.ul)
    ib = np.asarray(data.ib)
    rb = np.asarray(data.rb)
    if not isinstance(data.ul, np.ndarray):
        raise ValueError("compact_from_stream needs the HOST stream "
                         "(prepare_stream_sgd(device=False))")
    NB, B = ul.shape
    # local rows usually fit u16; huge user counts x pass striping can
    # blow the tile past it -> u32 (+2 B/rating), never a hard failure
    ul_dtype = np.uint16 if data.tile <= 65536 else np.uint32
    if B > 65536:
        raise ValueError(f"compact wire needs batch_size <= 65536 (u16 "
                         f"multiplicities); got {B}")

    # --- item ids: per-batch delta encode (ops/packed.py scheme) -------
    flat_i = ib.reshape(-1).astype(np.int64)
    delta = np.empty(flat_i.shape, np.int64)
    delta[0] = flat_i[0]
    np.subtract(flat_i[1:], flat_i[:-1], out=delta[1:])
    delta[::B] = flat_i[::B]  # batch start carries the absolute id
    hi = delta >> 16
    hp_flat = np.flatnonzero(hi)
    hv_flat = hi[hp_flat]
    lob = (delta & 0xFFFF).astype(np.uint16).reshape(NB, B)
    hb = hp_flat // B
    per_b = np.bincount(hb, minlength=NB)
    H = max(1, int(per_b.max(initial=0)))
    ihi_pos = np.zeros((NB, H), np.int32)
    ihi_val = np.zeros((NB, H), np.int32)
    col = (np.arange(len(hp_flat))
           - np.concatenate(([0], np.cumsum(per_b)))[hb])
    ihi_pos[hb, col] = (hp_flat % B).astype(np.int32)
    ihi_val[hb, col] = hv_flat.astype(np.int32)

    # --- ratings --------------------------------------------------------
    kind = rating_wire_kind(rb.reshape(-1))
    if kind == "half":
        rq = np.round(rb * 2.0).astype(np.int8)
    else:
        rq = rb.astype(np.float32)
        if rb.dtype.itemsize > 4 and not np.array_equal(
                rq.astype(rb.dtype), rb):
            raise ValueError("float64 ratings exceed the f32 raw wire; "
                             "use the flat stream")

    # --- multiplicities (weights recompute on device) -------------------
    if data.grad_mode in ("mean", "capped"):
        # user runs are NOT contiguous after the per-batch item sort:
        # count per (batch, local user) by bincount per batch
        mu = np.empty((NB, B), np.uint16)
        for b in range(NB):
            cnt = np.bincount(ul[b], minlength=data.tile)
            mu[b] = (cnt[ul[b]] - 1).astype(np.uint16)
        mi = (_run_lengths_sorted(flat_i, B) - 1).astype(
            np.uint16).reshape(NB, B)
    elif data.grad_mode == "sum":
        mu = np.zeros((NB, 1), np.uint16)
        mi = np.zeros((NB, 1), np.uint16)
    else:
        raise ValueError(f"unknown grad_mode {data.grad_mode!r}")

    comp = CompactStreamSGD(
        ul=ul.astype(ul_dtype), ilo=lob, ihi_pos=ihi_pos,
        ihi_val=ihi_val, rq=rq, mu=mu, mi=mi,
        u_lo=np.asarray(data.u_lo, np.int32), tile=data.tile,
        cap=int(cap), grad_mode=data.grad_mode, rating_kind=kind,
        n_items=int(n_items), n_real=data.n_real)
    if validate:
        dul, dib, drb, dwu, dwi = decode_compact(comp, rb.dtype)
        for name, got, want in (("ul", dul, ul.astype(np.int32)),
                                ("ib", dib, ib.astype(np.int32)),
                                ("rb", drb, rb),
                                ("wu", dwu, np.asarray(data.wu)),
                                ("wi", dwi, np.asarray(data.wi))):
            if not np.array_equal(got, want):
                raise ValueError(
                    f"compact wire round-trip mismatch on {name!r} "
                    f"(was prepare_stream_sgd called with cap={cap}?)")
    return comp


def _weights_from_mult(menc: np.ndarray, mask, cap: int, grad_mode: str,
                       dtype):
    """min(mult, t)/mult * mask, computed EXACTLY as the flat builder
    does (q = 1/mult first, then min(1/q, t) * q) so host validation is
    bitwise. ``menc`` is multiplicity - 1."""
    if grad_mode == "sum":
        return mask
    t = dtype.type(1.0) if grad_mode == "mean" else dtype.type(cap)
    m = menc.astype(dtype) + dtype.type(1.0)
    q = dtype.type(1.0) / m
    return np.minimum(dtype.type(1.0) / q, t) * q * mask


def decode_compact(comp: CompactStreamSGD, dtype):
    """Host (numpy) decode — the test/validation twin of the device
    decode in models/sgd_stream._decode_compact_batch. Returns
    (ul int32, ib int32, rb, wu, wi) matching the flat stream arrays."""
    dtype = np.dtype(dtype)
    NB, B = comp.ul.shape
    d = comp.ilo.astype(np.int64)
    np.add.at(d.reshape(NB, -1),
              (np.arange(NB)[:, None], comp.ihi_pos),
              comp.ihi_val.astype(np.int64) << 16)
    ib = np.cumsum(d.reshape(NB, B), axis=1).astype(np.int32)
    mask = (ib < comp.n_items).astype(dtype)
    if comp.rating_kind == "half":
        rb = comp.rq.astype(dtype) * dtype.type(0.5)
    else:
        rb = comp.rq.astype(dtype)
    wu = _weights_from_mult(comp.mu, mask, comp.cap, comp.grad_mode,
                            dtype)
    wi = _weights_from_mult(comp.mi, mask, comp.cap, comp.grad_mode,
                            dtype)
    # pad rows already encode rating 0 (rq pad = 0), so rb needs no mask
    return comp.ul.astype(np.int32), ib, rb, wu, wi


_WIRE_FIELDS = ("ul", "ilo", "ihi_pos", "ihi_val", "rq", "mu", "mi")


def put_compact(comp: CompactStreamSGD, device=None) -> CompactStreamSGD:
    """Pin the wire arrays on ``device`` (None: the card,
    ``resolve_device``) as tensors; ``u_lo`` (the tile starts, read by
    the host) and the statics stay."""
    device = resolve_device(device, "put_compact()")
    return comp._replace(**{n: wire_tensor(getattr(comp, n), device)
                            for n in _WIRE_FIELDS})


def compact_resident(comp: CompactStreamSGD) -> bool:
    return isinstance(comp.ul, torch.Tensor)


_META_FIELDS = ("tile", "cap", "grad_mode", "rating_kind", "n_items",
                "n_real")


def save_compact(comp: CompactStreamSGD, path: str) -> None:
    """Persist a HOST compact wire as one .npz (arrays + scalar meta).
    The wire is the cacheable artifact: decode_compact reconstructs the
    full flat stream from it, so tools cache ONLY the wire."""
    import json

    if compact_resident(comp):
        raise ValueError("save_compact wants the HOST wire (numpy)")
    arrays = {n: np.asarray(getattr(comp, n)) for n in
              ("ul", "ilo", "ihi_pos", "ihi_val", "rq", "mu", "mi",
               "u_lo")}
    meta = {n: getattr(comp, n) for n in _META_FIELDS}
    tmp = path + ".tmp.npz"  # .npz suffix so savez doesn't append one
    np.savez(tmp, __meta__=np.frombuffer(
        json.dumps(meta).encode(), np.uint8), **arrays)
    import os

    os.replace(tmp, path)


def load_compact(path: str) -> CompactStreamSGD:
    import json

    z = np.load(path)
    meta = json.loads(bytes(z["__meta__"]).decode())
    return CompactStreamSGD(
        **{n: z[n] for n in ("ul", "ilo", "ihi_pos", "ihi_val", "rq",
                             "mu", "mi", "u_lo")},
        **{n: meta[n] for n in _META_FIELDS})


def flat_from_compact(comp: CompactStreamSGD, dtype=np.float32):
    """Reconstruct the flat StreamSGDData (host) a cached wire encodes —
    the inverse of compact_from_stream, for flat-tier benches."""
    from ycnr_tpu_torch.models.sgd_stream import StreamSGDData

    ul, ib, rb, wu, wi = decode_compact(comp, dtype)
    return StreamSGDData(ul=ul, ib=ib, rb=rb, wu=wu, wi=wi,
                         u_lo=np.asarray(comp.u_lo, np.int32),
                         n_real=comp.n_real, tile=comp.tile,
                         grad_mode=comp.grad_mode)


def sgd_wire_budget(n_users: int, n_items: int, rank: int,
                    hbm_bytes: int | None = None, device=None) -> int:
    """Device bytes available for pinning the SGD wire: the card's memory
    (``models/ooc.device_hbm_stats``; ``hbm_bytes`` fixes it) minus what
    the epoch holds beside the wire: the extended factor tables and their
    per-epoch copies, a batch's decode temps, the streamed chunks and a
    1 GB margin."""
    if hbm_bytes is None:
        hbm_bytes = device_hbm_bytes(device)
    k1 = rank + 1
    reserve = (2 * (n_users + n_items + 2) * k1 * 4  # Ue/Ve + state copy
               + 65536 * k1 * 4 * 8                  # batch decode temps
               + 3 * 48 * 2**20                      # streamed chunks
               + 1_000_000_000)
    return max(0, hbm_bytes - reserve)

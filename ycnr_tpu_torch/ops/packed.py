"""Packed wire format for out-of-core training (the port's copy of
``ycnr_tpu/ops/packed.py``, NumPy only; it gives the same arrays as the
original, bit for bit, ``tests/test_torch_host_copies.py``).

Out-of-core training keeps only the factors resident on the device; the
rating blocks of the bucketed layout live in this compact wire form,
pinned in device memory or streamed from host memory every epoch
(``models/ooc.py``), so the trainable rating count is bounded by the
host's memory (or disk, through the memmap ``out_dir``s) rather than the
card's.

* per block, each entity's sorted rating row is stored PACKED (no padding
  slots; padding is 1/fill, about 1.6x);
* item/other indices are DELTA-encoded within each row (ascending, so
  deltas are small positive ints); the first element of a row carries the
  absolute id. Deltas ship as uint16 low halves plus a sparse
  (position, high-bits) overflow list, exact for any catalog size;
* ratings ship as int8 half-stars when exactly representable
  ((2r) integral, |2r| <= 127, true for MovieLens/Netflix scales), else
  raw float32. int8*0.5 is exact in f32, so parity is bitwise either way.

``RectGroup`` ships the padded rectangles instead (1/fill more bytes, a
decode without per-slot gathers).

Decoding (``models/ooc.py``) reproduces the resident bucketed blocks
BITWISE: same rung ladder (the ``_dp_rungs`` DP on the same counts), same
entity->block packing, same within-row (entity, other) sort. An OOC epoch
is therefore the SAME math as the resident epoch, block for block.
"""

from __future__ import annotations

import os
from typing import Iterable, NamedTuple, Optional, Tuple

import numpy as np

from ycnr_tpu_torch.ops.bucketed import _dp_rungs, entity_order


class PackedGroup(NamedTuple):
    """One rung group in wire format. Blocks along axis 0; each block's
    rows are concatenated without padding (row boundaries from ``cnt``).

    lo      [NB, S]  uint16  low 16 bits of the within-row index delta
                             (row-start element = the absolute id)
    hi_pos  [NB, H]  int32   positions in [0, S) whose delta overflows 16
                             bits (padding: position 0 with value 0 — a
                             scatter-add no-op)
    hi_val  [NB, H]  int32   delta >> 16 at those positions
    rat     [NB, S]  int8|f32 encoded rating (padding tail: 0)
    cnt     [NB, NE] int32   per-row rating count (padding rows: 0)
    eid     [NB, NE] int32   global entity ids (padding: n_entities)
    """

    lo: np.ndarray
    hi_pos: np.ndarray
    hi_val: np.ndarray
    rat: np.ndarray
    cnt: np.ndarray
    eid: np.ndarray
    R: int  # rung height (decoded row width)
    n_other: int
    rating_kind: str  # "half" (int8, value = rat * 0.5) | "raw" (float32)

    @property
    def n_blocks(self) -> int:
        return self.lo.shape[0]


PackedCSR = Tuple[PackedGroup, ...]


class RectGroup(NamedTuple):
    """One rung group in RECT wire format: the padded rectangles ship
    as-is, so the device decode needs no per-slot gathers (the packed
    format's unpack is two single-element gathers per slot).

    lo      [NB, NE, R] uint16  low 16 bits of the within-row id delta
                                (col 0 = the absolute id's low bits;
                                padding slots: 0)
    hi_pos  [NB, H]     int32   flattened [NE*R] positions whose delta
                                overflows 16 bits (padding: (0, 0) —
                                a scatter-add no-op)
    hi_val  [NB, H]     int32   delta >> 16 at those positions
    rat     [NB, NE, R] int8|f32 encoded rating (padding slots: 0)
    cnt     [NB, NE]    int32   per-row rating count (padding rows: 0)
    eid     [NB, NE]    int32   global entity ids (padding: n_entities)

    Wire cost is slots*(2+1) bytes vs the packed format's ~nnz*(2+1):
    1/fill (~1.3-1.6x) more bytes — but the padding is zeros, which the
    transport compresses, and the wire rides under compute via prefetch.
    """

    lo: np.ndarray
    hi_pos: np.ndarray
    hi_val: np.ndarray
    rat: np.ndarray
    cnt: np.ndarray
    eid: np.ndarray
    R: int
    n_other: int
    rating_kind: str

    @property
    def n_blocks(self) -> int:
        return self.lo.shape[0]


RectCSR = Tuple[RectGroup, ...]


def rating_wire_kind(rating: np.ndarray) -> str:
    """"half" when every rating is a half-star exactly representable as
    int8 (2r integral, |2r| <= 127), else "raw" float32. int8 -> f32 * 0.5
    is exact, so the choice never costs parity."""
    r2 = np.asarray(rating, np.float64) * 2.0
    if len(r2) and (np.all(r2 == np.round(r2)) and np.all(np.abs(r2) <= 127)):
        return "half"
    return "raw"


def _encode_rows(o_sorted: np.ndarray, r_sorted: np.ndarray,
                 row_starts: np.ndarray):
    """Delta-encode one block's concatenated sorted rows.

    o_sorted: [S_real] int32 other-indices, ascending within each row;
    row_starts: positions where a new row begins (ascending, starts at 0).
    Returns (lo u16, hi_pos i32, hi_val i32)."""
    S = o_sorted.shape[0]
    delta = np.empty(S, np.int64)
    if S:
        delta[0] = o_sorted[0]
        np.subtract(o_sorted[1:], o_sorted[:-1], out=delta[1:])
        delta[row_starts] = o_sorted[row_starts]  # absolute at row start
    hi = delta >> 16
    hi_pos = np.flatnonzero(hi).astype(np.int32)
    hi_val = hi[hi_pos].astype(np.int32)
    lo = (delta & 0xFFFF).astype(np.uint16)
    return lo, hi_pos, hi_val


class WireStoragePlan(NamedTuple):
    """Storage-order plan for one view ("wire-order storage").

    The factor table itself is kept in wire order for the whole run:
    blocks write their solved rows in place at the block's storage offset
    (``models/ooc.phase_packed_wire``). The price is an id relabeling:
    the OTHER view's wire must carry storage rows instead of entity ids
    (build_packed/build_packed_stream take an ``other_plan`` argument),
    and host-side consumers (eval COOs, checkpoints) map ids through
    ``perm`` once.

    Storage layout of a view's factor table ([table_rows, k]):

      [0, rows)                  wire rows — group blocks back to back,
                                 including each group's tail-padding rows
                                 (cnt-0 solves write exact zeros there)
      [rows, rows + n_cold)      cold entities (zero rating count): never
                                 written, keep their init values — the
                                 old scatter semantics
      [rows + n_cold, zero_row)  scratch — the JAX package's chunk-pad
                                 blocks dump their all-padding solves
                                 here (exact zeros); the port ships
                                 short chunks and never writes it
      zero_row (== table_rows-1) THE zero row: every padding gather in
                                 the twin view's decode points here, so
                                 it must stay zero (cnt-0 writes keep it
                                 zero even if a pad block lands on it)

    ``perm`` maps entity id -> storage row for real entities (wire or
    cold region). The geometry below is the SAME arithmetic as
    _pack_one_group/build_packed_stream, so a plan built from the counts
    alone agrees with the wire a later build emits (pinned in
    tests/test_ooc_wire.py and tests/test_torch_ooc_wire.py)."""

    perm: np.ndarray                 # [n_entities] int32
    offs: Tuple[np.ndarray, ...]     # per-group [nb] int32 block offsets
    rows: int
    n_cold: int
    scratch: int
    zero_row: int

    @property
    def table_rows(self) -> int:
        return self.zero_row + 1


def wire_storage_plan(counts: np.ndarray, rank_hint: int = 64,
                      target_bytes: int = 192 * 2**20,
                      max_groups: int = 16) -> WireStoragePlan:
    """Storage plan from per-entity rating counts (one bincount)."""
    counts = np.asarray(counts, np.int64)
    n_entities = len(counts)
    active = np.nonzero(counts)[0]
    perm = np.full(n_entities, -1, np.int64)
    offs = []
    base = 0
    scratch = 1
    if len(active):
        rung = _dp_rungs(counts[active], max_groups)
        for p in np.unique(rung):
            ents = active[rung == p]
            R = int(p)
            n_e = len(ents)
            ne_target = max(8, target_bytes // (R * rank_hint * 4))
            nb = max(1, -(-n_e // ne_target))
            ne_b = int(-(-(-(-n_e // nb)) // 8) * 8)
            perm[ents] = base + np.arange(n_e, dtype=np.int64)
            offs.append(base + np.arange(nb, dtype=np.int32) * ne_b)
            base += nb * ne_b
            scratch = max(scratch, ne_b)
    rows = int(base)
    cold = np.nonzero(perm < 0)[0]
    perm[cold] = rows + np.arange(len(cold), dtype=np.int64)
    zero_row = rows + len(cold) + scratch
    return WireStoragePlan(perm=perm.astype(np.int32), offs=tuple(offs),
                           rows=rows, n_cold=int(len(cold)),
                           scratch=int(scratch), zero_row=int(zero_row))


def _pack_one_group(ents: np.ndarray, counts: np.ndarray,
                    starts: np.ndarray, o_sorted: np.ndarray,
                    r_sorted: np.ndarray, R: int, n_entities: int,
                    n_other: int, rank_hint: int, target_bytes: int,
                    kind: str) -> PackedGroup:
    """Pack one rung group's entities (``ents``, ascending) into wire
    blocks. Block sizing mirrors ops/bucketed.build_bucketed exactly
    (balanced NE_b from the gathered-tensor byte target) so the decoded
    blocks are bitwise the resident ones."""
    n_e = len(ents)
    ne_target = max(8, target_bytes // (R * rank_hint * 4))
    nb = max(1, -(-n_e // ne_target))
    ne_b = int(-(-(-(-n_e // nb)) // 8) * 8)  # ceil(n_e/nb) to mult of 8

    cnt = np.zeros(nb * ne_b, np.int32)
    eidv = np.full(nb * ne_b, n_entities, np.int32)
    eidv[:n_e] = ents
    cnt[:n_e] = counts[ents]
    cnt2 = cnt.reshape(nb, ne_b)
    eid2 = eidv.reshape(nb, ne_b)

    per_block = cnt2.sum(axis=1)
    S = int(per_block.max(initial=0))
    lo = np.zeros((nb, S), np.uint16)
    rdt = np.int8 if kind == "half" else np.float32
    rat = np.zeros((nb, S), rdt)
    his = []
    for b in range(nb):
        sel = eid2[b][eid2[b] < n_entities]
        if len(sel) == 0:
            his.append((np.zeros(0, np.int32), np.zeros(0, np.int32)))
            continue
        # concatenate this block's rows from the (entity, other)-sorted COO
        spans_s = starts[sel]
        spans_t = starts[sel + 1]
        idx = _concat_ranges(spans_s, spans_t)
        ob = o_sorted[idx]
        rb = r_sorted[idx]
        row_starts = np.zeros(len(sel), np.int64)
        np.cumsum(spans_t[:-1] - spans_s[:-1], out=row_starts[1:])
        l, hp, hv = _encode_rows(ob, rb, row_starts)
        lo[b, : len(l)] = l
        if kind == "half":
            rat[b, : len(l)] = np.round(rb * 2.0).astype(np.int8)
        else:
            rat[b, : len(l)] = rb
        his.append((hp, hv))
    H = max(1, max((len(hp) for hp, _ in his), default=1))
    hi_pos = np.zeros((nb, H), np.int32)
    hi_val = np.zeros((nb, H), np.int32)
    for b, (hp, hv) in enumerate(his):
        hi_pos[b, : len(hp)] = hp
        hi_val[b, : len(hp)] = hv
    return PackedGroup(lo, hi_pos, hi_val, rat, cnt2, eid2, int(R),
                       int(n_other), kind)


def _concat_ranges(s: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Vectorized np.concatenate([arange(a, b) for a, b in zip(s, t)])."""
    lens = (t - s).astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    out = np.ones(total, np.int64)
    row_starts = np.zeros(len(s), np.int64)
    np.cumsum(lens[:-1], out=row_starts[1:])
    out[0] = s[0]
    nz = row_starts[1:]
    out[nz] = s[1:] - (s[:-1] + lens[:-1] - 1)
    return np.cumsum(out)


def build_packed(entity_idx, other_idx, rating, n_entities: int,
                 n_other: int, rank_hint: int = 64,
                 target_bytes: int = 192 * 2**20,
                 max_groups: int = 16,
                 other_plan: Optional[WireStoragePlan] = None) -> PackedCSR:
    """Wire-format twin of ops/bucketed.build_bucketed: identical rung
    ladder, identical entity->group/block assignment, identical within-row
    sort — the decoded blocks match the resident ones bitwise (pinned in
    tests/test_ooc.py). Use for datasets whose COO fits host RAM but whose
    layout would not fit device memory; build_packed_stream below is the
    bounded-host-RAM portioned variant.

    ``other_plan`` switches the wire to WIRE-ORDER STORAGE mode (see
    WireStoragePlan): other-idx values are relabeled to the twin view's
    storage rows BEFORE the within-row sort (rows re-sort in storage-id
    space, so the delta encoding stays ascending — reduction order
    therefore differs from the entity-id wire by a per-row permutation),
    and the groups' ``n_other`` sentinel becomes the twin table's zero
    row. Decoded blocks feed models/ooc.phase_packed_wire directly."""
    entity_idx = np.asarray(entity_idx, dtype=np.int64)
    o_all = np.asarray(other_idx, dtype=np.int64)
    r_all = np.asarray(rating, dtype=np.float32)
    if not (len(entity_idx) == len(o_all) == len(r_all)):
        raise ValueError("COO arrays must share length")
    if len(entity_idx) and (entity_idx.max() >= n_entities
                            or o_all.max() >= n_other
                            or entity_idx.min() < 0 or o_all.min() < 0):
        raise ValueError("index out of range")
    if other_plan is not None:
        o_all = other_plan.perm[o_all].astype(np.int64)
        n_other = other_plan.zero_row
    order = entity_order(entity_idx, o_all, n_other)
    o_sorted = np.ascontiguousarray(o_all[order], np.int32)
    r_sorted = np.ascontiguousarray(r_all[order], np.float32)
    counts = np.bincount(entity_idx, minlength=n_entities).astype(np.int64)
    starts = np.zeros(n_entities + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    kind = rating_wire_kind(r_sorted)

    active = np.nonzero(counts)[0]
    rung = _dp_rungs(counts[active], max_groups)
    groups = []
    for p in np.unique(rung):
        ents = active[rung == p]
        groups.append(_pack_one_group(ents, counts, starts, o_sorted,
                                      r_sorted, int(p), n_entities,
                                      n_other, rank_hint, target_bytes,
                                      kind))
    return tuple(groups)


def build_packed_stream(
    portions: Iterable[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    n_entities: int, n_other: int, *, counts: Optional[np.ndarray] = None,
    portions2: Optional[Iterable] = None, rank_hint: int = 64,
    target_bytes: int = 192 * 2**20, max_groups: int = 16,
    out_dir: Optional[str] = None, view: str = "entity",
    rating_kind: Optional[str] = None,
    other_plan: Optional[WireStoragePlan] = None,
) -> PackedCSR:
    """True out-of-core builder: two passes over a portions iterator
    (the reference's portioned SELECT streaming — data/store.py:stream),
    never materializing the full COO.

    ``portions`` yields (u, i, r) batches; ``view`` picks which column is
    the entity axis ("entity" = first column, "other" = swapped — the
    transposed per-item view). Pass 1 counts;
    pass 2 scatters each portion into its packed destination (RAM, or
    memmaps under ``out_dir`` for layouts beyond RAM). Rows are then
    sorted in place block-by-block, so the result is BITWISE
    build_packed(full COO) (pinned in tests/test_ooc.py).

    ``counts``/``rating_kind`` skip pass 1 when the caller already knows
    them; ``portions2`` supplies a fresh iterator for pass 2 when
    ``portions`` is single-shot (a generator).
    """
    if view not in ("entity", "other"):
        raise ValueError("view must be 'entity' or 'other'")

    def _oriented(p):
        u, i, r = p
        return (u, i, r) if view == "entity" else (i, u, r)

    if counts is None or rating_kind is None:
        if portions2 is None:
            portions = list(portions)  # must re-iterate; keep refs
            portions2 = portions
        counts = np.zeros(n_entities, np.int64)
        kind = "half"
        seen = False
        for p in portions:
            e, o, r = _oriented(p)
            if len(e) and (np.max(e) >= n_entities or np.max(o) >= n_other
                           or np.min(e) < 0 or np.min(o) < 0):
                raise ValueError("index out of range")
            counts += np.bincount(e, minlength=n_entities)
            if kind == "half" and rating_wire_kind(r) != "half":
                kind = "raw"
            seen = seen or len(e) > 0
        rating_kind = rating_kind or kind
    else:
        if portions2 is None:
            portions2 = portions
        counts = np.asarray(counts, np.int64)

    if other_plan is not None:
        # wire-order storage mode: pass-2 stores storage rows, the sort
        # key and the decode sentinel use the twin table's zero row
        n_other = other_plan.zero_row

    active = np.nonzero(counts)[0]
    rung = _dp_rungs(counts[active], max_groups)
    rungs = np.unique(rung)

    # per-group geometry (identical arithmetic to _pack_one_group)
    metas = []  # (R, nb, ne_b, cnt2, eid2, S)
    # entity -> (group, flat destination base within the group's [NB*S])
    group_of = np.full(n_entities, -1, np.int32)
    dest_base = np.zeros(n_entities, np.int64)
    for gi, p in enumerate(rungs):
        ents = active[rung == p]
        R = int(p)
        n_e = len(ents)
        ne_target = max(8, target_bytes // (R * rank_hint * 4))
        nb = max(1, -(-n_e // ne_target))
        ne_b = int(-(-(-(-n_e // nb)) // 8) * 8)
        cnt = np.zeros(nb * ne_b, np.int32)
        eidv = np.full(nb * ne_b, n_entities, np.int32)
        eidv[:n_e] = ents
        cnt[:n_e] = counts[ents]
        cnt2 = cnt.reshape(nb, ne_b)
        S = int(cnt2.sum(axis=1).max(initial=0))
        # packed row starts within each block, flattened to [NB*S]
        row_start = np.zeros(nb * ne_b, np.int64)
        c = cnt2.astype(np.int64)
        within = np.cumsum(c, axis=1) - c  # exclusive per-block cumsum
        row_start = (within + (np.arange(nb, dtype=np.int64)[:, None] * S)
                     ).reshape(-1)
        group_of[eidv[:n_e]] = gi
        dest_base[eidv[:n_e]] = row_start[:n_e]
        metas.append((R, nb, ne_b, cnt2, eidv.reshape(nb, ne_b), S))

    def _alloc(name, shape, dtype):
        if out_dir is None:
            return np.zeros(shape, dtype)
        os.makedirs(out_dir, exist_ok=True)
        return np.lib.format.open_memmap(
            os.path.join(out_dir, name + ".npy"), mode="w+", dtype=dtype,
            shape=shape)

    rdt = np.int8 if rating_kind == "half" else np.float32
    flat_o = [_alloc(f"g{gi}.oi32", (m[1] * m[5],), np.int32)
              for gi, m in enumerate(metas)]
    flat_r = [_alloc(f"g{gi}.rat", (m[1] * m[5],), rdt)
              for gi, m in enumerate(metas)]

    cursor = np.zeros(n_entities, np.int64)
    for p in portions2:
        e, o, r = _oriented(p)
        e = np.asarray(e, np.int64)
        o = np.asarray(o, np.int32)
        if other_plan is not None:
            o = other_plan.perm[o]
        r = np.asarray(r, np.float32)
        # occurrence rank of each duplicate entity within this portion
        sort = np.argsort(e, kind="stable")
        es = e[sort]
        brk = np.empty(len(es), bool)
        if len(es):
            brk[0] = True
            np.not_equal(es[1:], es[:-1], out=brk[1:])
        run_starts = np.flatnonzero(brk)
        run_id = np.zeros(len(es), np.int64)
        run_id[run_starts[1:]] = 1
        run_id = np.cumsum(run_id)
        occ = np.arange(len(es), dtype=np.int64) - run_starts[run_id]
        dest = dest_base[es] + cursor[es] + occ
        gsel = group_of[es]
        for gi in range(len(metas)):
            m = gsel == gi
            if not m.any():
                continue
            d = dest[m]
            flat_o[gi][d] = o[sort[m]]
            if rating_kind == "half":
                flat_r[gi][d] = np.round(
                    r[sort[m]] * 2.0).astype(np.int8)
            else:
                flat_r[gi][d] = r[sort[m]]
        cursor += np.bincount(e, minlength=n_entities)
    if not np.array_equal(cursor, counts):
        raise ValueError("pass-2 portions did not match pass-1 counts "
                         "(the stream must be re-iterable and stable)")

    # per-block: sort rows by other-idx, delta-encode, emit wire arrays
    groups = []
    for gi, (R, nb, ne_b, cnt2, eid2, S) in enumerate(metas):
        lo = _alloc(f"g{gi}.lo", (nb, S), np.uint16)
        rat = _alloc(f"g{gi}.ratw", (nb, S), rdt)
        his = []
        fo = flat_o[gi]
        fr = flat_r[gi]
        for b in range(nb):
            n_real = int(cnt2[b].sum())
            ob = np.asarray(fo[b * S : b * S + n_real])
            rb = np.asarray(fr[b * S : b * S + n_real])
            c = cnt2[b].astype(np.int64)
            row_starts = np.cumsum(c) - c
            rs_real = row_starts[cnt2[b] > 0]
            # within-row sort by other idx (rows are variable-length runs:
            # composite key row_id * (n_other + 1) + other is monotone in
            # (row, other), one argsort sorts every row at once)
            row_id = np.zeros(n_real, np.int64)
            row_id[rs_real[1:]] = 1
            row_id = np.cumsum(row_id)
            srt = np.argsort(row_id * (n_other + 1) + ob, kind="stable")
            ob = ob[srt].astype(np.int32)
            rb = rb[srt]
            l, hp, hv = _encode_rows(ob, rb, rs_real)
            lo[b, : len(l)] = l
            rat[b, : len(l)] = rb
            his.append((hp, hv))
        H = max(1, max((len(hp) for hp, _ in his), default=1))
        hi_pos = np.zeros((nb, H), np.int32)
        hi_val = np.zeros((nb, H), np.int32)
        for b, (hp, hv) in enumerate(his):
            hi_pos[b, : len(hp)] = hp
            hi_val[b, : len(hp)] = hv
        if out_dir is not None:
            lo.flush()
            rat.flush()
            # drop the int32 intermediates from disk
            del fo, fr
            for suffix in ("oi32", "rat"):
                fp = os.path.join(out_dir, f"g{gi}.{suffix}.npy")
                if os.path.exists(fp):
                    os.remove(fp)
        groups.append(PackedGroup(lo, hi_pos, hi_val, rat, cnt2, eid2,
                                  int(R), int(n_other), rating_kind))
    return tuple(groups)


def rect_from_packed(g: PackedGroup, out_dir: Optional[str] = None,
                     gi: int = 0) -> RectGroup:
    """Expand one packed group to the RECT wire format on the host —
    the same nnz-sized scatter the device decode used to pay every
    epoch, paid ONCE here (and cached to disk by the callers).

    Bitwise contract: decode_block_rect(rect) == decode_block(packed)
    slot for slot (pinned in tests/test_ooc.py)."""
    nb, ne = g.cnt.shape
    R = g.R

    def _alloc(name, shape, dtype):
        if out_dir is None:
            return np.zeros(shape, dtype)
        os.makedirs(out_dir, exist_ok=True)
        return np.lib.format.open_memmap(
            os.path.join(out_dir, name + ".npy"), mode="w+", dtype=dtype,
            shape=shape)

    lo = _alloc(f"g{gi}.lo", (nb, ne, R), np.uint16)
    rat = _alloc(f"g{gi}.rat", (nb, ne, R), g.rat.dtype)
    his = []
    for b in range(nb):
        c = np.asarray(g.cnt[b], np.int64)
        n_real = int(c.sum())
        if n_real == 0:
            his.append((np.zeros(0, np.int32), np.zeros(0, np.int32)))
            continue
        starts = np.cumsum(c) - c
        rows = np.repeat(np.arange(ne, dtype=np.int64), c)
        cols = np.arange(n_real, dtype=np.int64) - np.repeat(starts, c)
        flat = rows * R + cols  # packed position p lives at rect flat[p]
        lo[b].reshape(-1)[flat] = np.asarray(g.lo[b][:n_real])
        rat[b].reshape(-1)[flat] = np.asarray(g.rat[b][:n_real])
        hp = np.asarray(g.hi_pos[b])
        hv = np.asarray(g.hi_val[b])
        # invariant from _encode_rows: real hi entries are nonzero (an id
        # delta >= 1<<16 has hi >= 1) and hi_pos/hi_val pad with (0, 0) —
        # so hv != 0 separates real corrections from padding exactly. If
        # the encoder ever emits zero/signed hi values, track per-block hi
        # lengths here instead.
        m = hv != 0
        his.append((flat[hp[m]].astype(np.int32), hv[m].astype(np.int32)))
    H = max(1, max((len(hp) for hp, _ in his), default=1))
    hi_pos = np.zeros((nb, H), np.int32)
    hi_val = np.zeros((nb, H), np.int32)
    for b, (hp, hv) in enumerate(his):
        hi_pos[b, : len(hp)] = hp
        hi_val[b, : len(hp)] = hv
    return RectGroup(lo, hi_pos, hi_val, rat, g.cnt, g.eid, int(R),
                     int(g.n_other), g.rating_kind)


def build_rect(entity_idx, other_idx, rating, n_entities: int,
               n_other: int, rank_hint: int = 64, *,
               out_dir: Optional[str] = None, **kw) -> RectCSR:
    """build_packed + rect expansion: the default OOC wire (fast decode);
    use build_packed directly when host RAM/disk is the binding
    constraint (rect is 1/fill larger at rest). Positional signature
    mirrors build_packed (rank_hint 6th) so callers can swap them."""
    pk = build_packed(entity_idx, other_idx, rating, n_entities, n_other,
                      rank_hint=rank_hint, **kw)
    return tuple(rect_from_packed(g, out_dir=out_dir, gi=gi)
                 for gi, g in enumerate(pk))


def packed_stats(groups: PackedCSR, nnz: int) -> dict:
    wire = sum(int(g.lo.nbytes + g.rat.nbytes + g.hi_pos.nbytes
                   + g.hi_val.nbytes + g.cnt.nbytes + g.eid.nbytes)
               for g in groups)
    slots = sum(int(g.cnt.shape[0] * g.cnt.shape[1] * g.R) for g in groups)
    return {
        "n_groups": len(groups),
        "rows_per_group": [g.R for g in groups],
        "blocks_per_group": [g.n_blocks for g in groups],
        "wire_bytes": wire,
        "wire_bytes_per_rating": wire / max(nnz, 1),
        "decoded_slots": slots,
        "fill": nnz / slots if slots else 0.0,
        "rating_kind": groups[0].rating_kind if groups else "raw",
    }

"""The port's out-of-core ALS-WR / iALS (``models/ooc.py`` over the wire of
``ops/packed.py``) against ``ycnr_tpu.models.ooc`` on the same inputs: the
cases of ``tests/test_ooc.py``, each run through both packages.

Where the JAX test holds its OOC path to its resident path bit for bit,
the port's OOC path is held to the port's resident path bit for bit (a
decoded wire block is the resident block and the block step is the
same), and both are held to the JAX package's OOC result within 1e-9 in
float64 (the port's parity tolerance: torch and XLA sum in other
orders). Decodes and builders are integer or exact arithmetic and equal
the JAX package's bit for bit. On the CPU a group is "resident" when its
arrays are tensors and streamed when they are NumPy arrays, so both tiers
and the mixed epoch run here.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ycnr_tpu.models import base as jbase
from ycnr_tpu.models import ooc as jooc
from ycnr_tpu.ops import packed as jpacked
from ycnr_tpu_torch.data.synthetic import synthetic_ratings
from ycnr_tpu_torch.models import base as tbase
from ycnr_tpu_torch.models import bucketed_phase as tbp
from ycnr_tpu_torch.models import ooc as tooc
from ycnr_tpu_torch.ops import packed as tpacked
from ycnr_tpu_torch.ops.bucketed import build_bucketed
from ycnr_tpu_torch.ops.layout import pad_coo

torch.set_num_threads(1)

NU, NI, K = 700, 300, 16
BUILD = dict(rank_hint=16, target_bytes=1 << 20, max_groups=4)
LAM, ALPHA = 0.05, 20.0
TOL = dict(rtol=1e-9, atol=1e-12)
NAMES = ("lo", "hi_pos", "hi_val", "rat", "cnt")


@pytest.fixture(scope="module")
def coo():
    u, i, r = synthetic_ratings(NU, NI, 30_000, seed=3)[:3]
    return np.asarray(u), np.asarray(i), np.asarray(r)


@pytest.fixture(scope="module")
def layouts(coo):
    u, i, r = coo
    return (build_bucketed(u, i, r, NU, NI, **BUILD),
            build_bucketed(i, u, r, NI, NU, **BUILD),
            tpacked.build_packed(u, i, r, NU, NI, **BUILD),
            tpacked.build_packed(i, u, r, NI, NU, **BUILD))


@pytest.fixture(scope="module")
def rect_layouts(layouts):
    return (tuple(tpacked.rect_from_packed(g) for g in layouts[2]),
            tuple(tpacked.rect_from_packed(g) for g in layouts[3]))


def tstate(dtype=torch.float64):
    return tbase.init_state(NU, NI, K, seed=5, dtype=dtype, device="cpu")


def jstate(dtype=jnp.float64):
    return jbase.init_state(NU, NI, K, seed=5, dtype=dtype)


@pytest.fixture(scope="module")
def resident(layouts):
    """The port's resident bucketed epochs from the same start (float64):
    what its OOC epochs must equal bit for bit."""
    ug = tbp.device_bucketed(layouts[0], torch.float64, "cpu")
    ig = tbp.device_bucketed(layouts[1], torch.float64, "cpu")
    return {"als": tbp.als_epoch_fn(ug, ig, LAM)(tstate()),
            "ials": tbp.ials_epoch_fn(ug, ig, LAM, ALPHA)(tstate())}


@pytest.fixture(scope="module")
def jax_ooc(layouts):
    """The JAX package's OOC epochs on the same wire and start."""
    upk, ipk = layouts[2:]
    return {"als": jooc.als_epoch_ooc(jstate(), upk, ipk, LAM),
            "ials": jooc.ials_epoch_ooc(jstate(), upk, ipk, LAM, ALPHA)}


def assert_epoch(got, kind, resident, jax_ooc):
    ref, jref = resident[kind], jax_ooc[kind]
    assert torch.equal(got.U, ref.U) and torch.equal(got.V, ref.V)
    np.testing.assert_allclose(got.U.numpy(), np.asarray(jref.U), **TOL)
    np.testing.assert_allclose(got.V.numpy(), np.asarray(jref.V), **TOL)


def tblock(g, b):
    return [tooc.wire_tensor(getattr(g, n)[b], "cpu") for n in NAMES]


def jblock(g, b):
    return [jnp.asarray(getattr(g, n)[b]) for n in NAMES]


def assert_decodes(res, wire, rect):
    """Every block of ``wire`` decodes, in both packages, to the resident
    block of ``res``."""
    tdec = tooc.decode_block_rect if rect else tooc.decode_block
    jdec = jooc.decode_block_rect if rect else jooc.decode_block
    for g_r, g_p in zip(res, wire, strict=True):
        assert g_r.rows == g_p.R
        assert g_r.other_idx.shape[0] == g_p.n_blocks
        for b in range(g_p.n_blocks):
            oi, rr = tdec(*tblock(g_p, b), g_p.R, g_p.n_other,
                          torch.float32)
            joi, jrr = jdec(*jblock(g_p, b), g_p.R, g_p.n_other,
                            jnp.float32)
            assert np.array_equal(oi.numpy(), g_r.other_idx[b])
            assert np.array_equal(rr.numpy(), g_r.rating[b])
            assert np.array_equal(oi.numpy(), np.asarray(joi))
            assert np.array_equal(rr.numpy(), np.asarray(jrr))
            assert np.array_equal(g_p.eid[b], g_r.entity_ids[b])


def test_decode_blocks_bitwise(layouts):
    """Every decoded packed block equals its resident twin and the JAX
    package's decode, exactly."""
    assert_decodes(layouts[0], layouts[2], rect=False)
    assert_decodes(layouts[1], layouts[3], rect=False)


def test_decode_rect_blocks_bitwise(layouts, rect_layouts):
    for res, rc in ((layouts[0], rect_layouts[0]),
                    (layouts[1], rect_layouts[1])):
        assert all(g.lo.ndim == 3 and g.lo.shape[2] == g.R for g in rc)
        assert_decodes(res, rc, rect=True)


@pytest.mark.parametrize("rect", [False, True])
def test_hi_overflow_exact(rect):
    """Catalogs past 2^16 force 16-bit delta overflows (deltas >= 32,768
    have the int16 bits' sign set); the sparse (position, high-bits) list
    rebuilds the ids exactly, packed and RECT."""
    rng = np.random.default_rng(0)
    n_other = 500_000
    e = np.repeat(np.arange(40), 25)
    o = rng.integers(0, n_other, len(e)).astype(np.int64)
    r = np.full(len(e), 3.0, np.float32)
    res = build_bucketed(e, o, r, 40, n_other, **BUILD)
    build = tpacked.build_rect if rect else tpacked.build_packed
    wire = build(e, o, r, 40, n_other, **BUILD)
    assert any(g.hi_val.any() for g in wire), "must exercise overflow"
    assert any((g.lo >= 32768).any() for g in wire)
    assert_decodes(res, wire, rect=rect)


def test_rating_wire_kinds():
    for r in ([0.5, 3.0, 5.0], [0.3], [100.0]):
        a = np.asarray(r, np.float32)
        assert tpacked.rating_wire_kind(a) == jpacked.rating_wire_kind(a)
    assert tpacked.rating_wire_kind(np.asarray([0.5, 5.0])) == "half"
    # the raw kind round-trips arbitrary float ratings bitwise
    rng = np.random.default_rng(1)
    e = np.repeat(np.arange(20), 10)
    o = np.tile(np.arange(10), 20)
    r = rng.standard_normal(200).astype(np.float32)
    res = build_bucketed(e, o, r, 20, 10, **BUILD)
    pk = tpacked.build_packed(e, o, r, 20, 10, **BUILD)
    assert pk[0].rating_kind == "raw"
    assert_decodes(res, pk, rect=False)


@pytest.mark.parametrize("cb", [None, 2])
def test_als_epoch_parity_f64(layouts, resident, jax_ooc, cb):
    """A streamed ALS epoch equals the resident epoch bit for bit,
    including a short last chunk (cb = 2)."""
    got = tooc.als_epoch_ooc(tstate(), layouts[2], layouts[3], LAM,
                             chunk_blocks=cb)
    assert_epoch(got, "als", resident, jax_ooc)


@pytest.mark.parametrize("cb", [None, 2])
def test_als_epoch_parity_f64_rect(rect_layouts, resident, jax_ooc, cb):
    got = tooc.als_epoch_ooc(tstate(), *rect_layouts, LAM, chunk_blocks=cb)
    assert_epoch(got, "als", resident, jax_ooc)


def test_ials_epoch_parity_f64(layouts, resident, jax_ooc):
    got = tooc.ials_epoch_ooc(tstate(), layouts[2], layouts[3], LAM, ALPHA)
    assert_epoch(got, "ials", resident, jax_ooc)


def test_ials_epoch_parity_f64_rect(rect_layouts, resident, jax_ooc):
    got = tooc.ials_epoch_ooc(tstate(), *rect_layouts, LAM, ALPHA)
    assert_epoch(got, "ials", resident, jax_ooc)


def test_als_epoch_parity_row_subchunked(layouts, resident, jax_ooc,
                                         monkeypatch):
    """The gather-size cap is a memory knob, never a math knob: row
    sub-chunks keep every entity's reduction whole, so forcing every
    block to split over rows reproduces the epoch bit for bit."""
    monkeypatch.setattr(tooc, "_GATHER_CHUNK_BYTES", 1)
    real_plan = tooc._split_plan
    monkeypatch.setattr(tooc, "_split_plan",
                        lambda NE, R, k, isz: (real_plan(NE, R, k, isz)[0],
                                               1))
    assert all(tooc._row_split(int(g.cnt.shape[1]), int(g.R), K, 8) > 1
               for g in layouts[2])  # the cap engages at this size
    got = tooc.als_epoch_ooc(tstate(), layouts[2], layouts[3], LAM)
    assert_epoch(got, "als", resident, jax_ooc)


def test_als_epoch_parity_rating_split_accumulate(layouts, resident,
                                                  monkeypatch):
    """Blocks too skinny to split by rows split the rating axis and
    accumulate the Gram / RHS over R-chunks: that reassociates each
    entity's sum, so the epoch agrees to reduction-order tightness (the
    JAX test's 1e-11 / 1e-12), and rmse_wire, which shares the split,
    does not move."""
    upk, ipk = layouts[2:]
    monkeypatch.setattr(tooc, "_GATHER_CHUNK_BYTES", 1)
    assert any(tooc._split_plan(int(g.cnt.shape[1]), int(g.R), K, 8)[1] > 1
               for g in upk)
    got = tooc.als_epoch_ooc(tstate(), upk, ipk, LAM)
    ref = resident["als"]
    np.testing.assert_allclose(got.U.numpy(), ref.U.numpy(), rtol=1e-11,
                               atol=1e-12)
    np.testing.assert_allclose(got.V.numpy(), ref.V.numpy(), rtol=1e-11,
                               atol=1e-12)
    nnz = int(sum(g.cnt.sum() for g in upk))
    split_rm = tooc.rmse_wire(got, upk, nnz, gather_bf16=False)
    monkeypatch.setattr(tooc, "_GATHER_CHUNK_BYTES", 512 * 2**20)
    assert abs(tooc.rmse_wire(got, upk, nnz, gather_bf16=False)
               - split_rm) < 1e-9


@pytest.mark.parametrize("cb", [1, 2, 3])
def test_chunked_stream_parity_f64(coo, resident, cb):
    """Chunk size is a transport knob: a wire packed with a tiny block
    target (groups of many blocks, short last chunks) reproduces the
    resident epoch bit for bit for any chunk_blocks."""
    u, i, r = coo
    small = dict(BUILD, target_bytes=1 << 17)
    upk = tpacked.build_packed(u, i, r, NU, NI, **small)
    ipk = tpacked.build_packed(i, u, r, NI, NU, **small)
    assert any(g.n_blocks > 2 and g.n_blocks % cb for g in upk) or cb == 1
    got = tooc.als_epoch_ooc(tstate(), upk, ipk, LAM, chunk_blocks=cb)
    ref = resident["als"]
    assert torch.equal(got.U, ref.U) and torch.equal(got.V, ref.V)


def test_multi_epoch_rmse_trajectory(coo, layouts):
    """3 OOC epochs in f32 equal the port's resident trajectory and track
    the JAX package's OOC trajectory (its test's 1e-5), falling."""
    u, i, r = coo
    test = pad_coo(u[:2000], i[:2000], r[:2000], NU, NI)
    ug = tbp.device_bucketed(layouts[0], torch.float32, "cpu")
    ig = tbp.device_bucketed(layouts[1], torch.float32, "cpu")
    st_r, st_o, st_j = (tstate(torch.float32), tstate(torch.float32),
                        jstate(jnp.float32))
    hist_r, hist_o, hist_j = [], [], []
    for _ in range(3):
        st_r = tbp.als_epoch_fn(ug, ig, LAM)(st_r)
        hist_r.append(float(tbase.rmse_padded(st_r, *test)))
        st_o = tooc.als_epoch_ooc(st_o, layouts[2], layouts[3], LAM)
        hist_o.append(float(tbase.rmse_padded(st_o, *test)))
        st_j = jooc.als_epoch_ooc(st_j, layouts[2], layouts[3], LAM)
        hist_j.append(float(jbase.rmse_padded(st_j, *test)))
    assert hist_o == hist_r
    np.testing.assert_allclose(hist_o, hist_j, rtol=1e-5)
    assert hist_o[-1] < hist_o[0]


def test_hbm_resident_wire_parity_f64(layouts, resident, jax_ooc):
    """A wire pinned as tensors runs the same epoch as the streamed wire,
    bit for bit; "auto" upgrades packed groups to RECT on the way in."""
    upk, ipk = layouts[2:]
    du, di, pinned = tooc.wire_to_device(upk, ipk, pin_format="keep",
                                         device="cpu")
    assert all(tooc.group_resident(g) for g in (*du, *di))
    assert pinned == tooc.wire_nbytes(upk, ipk) == jooc.wire_nbytes(upk, ipk)
    assert_epoch(tooc.als_epoch_ooc(tstate(), du, di, LAM), "als",
                 resident, jax_ooc)
    da, dia, pinned_a = tooc.wire_to_device(upk, ipk, device="cpu")
    assert all(tooc.group_resident(g) and g.lo.ndim == 3
               for g in (*da, *dia))
    assert pinned_a >= pinned  # rect ships the padding slots
    assert pinned_a == jooc.wire_to_device(upk, ipk)[2]
    assert_epoch(tooc.als_epoch_ooc(tstate(), da, dia, LAM), "als",
                 resident, jax_ooc)


def test_partial_residency_budget_split(layouts, resident, jax_ooc):
    """A budget that fits only some groups pins the largest ones (the same
    ones as the JAX package), leaves the rest on the host, and the mixed
    epoch is still bit for bit the resident one."""
    upk, ipk = layouts[2:]
    sizes = sorted((sum(getattr(g, n).nbytes for n in tooc._WIRE_NAMES)
                    for g in (*upk, *ipk)), reverse=True)
    budget = sizes[0] + sizes[1] + sizes[2] // 2  # exactly 2 groups fit
    du, di, pinned = tooc.wire_to_device(upk, ipk, budget, device="cpu")
    ju, ji, jpinned = jooc.wire_to_device(upk, ipk, budget)
    assert pinned == jpinned <= budget
    assert ([tooc.group_resident(g) for g in (*du, *di)]
            == [jooc.group_resident(g) for g in (*ju, *ji)])
    assert 0 < sum(tooc.group_resident(g) for g in (*du, *di)) < \
        len(du) + len(di)
    assert_epoch(tooc.als_epoch_ooc(tstate(), du, di, LAM), "als",
                 resident, jax_ooc)


def test_rmse_wire_matches_padded_coo(coo, layouts):
    """rmse_wire (train RMSE straight off the wire) agrees with the
    padded-COO evaluator and with the JAX package's rmse_wire."""
    u, i, r = coo
    upk, ipk = layouts[2:]
    st = tooc.als_epoch_ooc(tstate(torch.float32), upk, ipk, LAM)
    want = float(tbase.rmse_padded(st, *pad_coo(u, i, r, NU, NI)))
    got = tooc.rmse_wire(st, upk, len(r), gather_bf16=False)
    assert abs(got - want) < 1e-5
    js = jbase.MFState(*(jnp.asarray(x) for x in tbase.to_numpy(st)))
    assert abs(got - jooc.rmse_wire(js, upk, len(r), gather_bf16=False)) \
        < 1e-5
    # bf16 prediction: display-grade agreement
    bf = tooc.rmse_wire(st, upk, len(r))
    assert abs(bf - want) < 3e-3
    assert abs(bf - jooc.rmse_wire(js, upk, len(r))) < 1e-5
    du, _, _ = tooc.wire_to_device(upk, ipk, device="cpu")
    assert abs(tooc.rmse_wire(st, du, len(r), gather_bf16=False)
               - want) < 1e-5


def _runs(tmp_path, cfg, ds, which):
    from ycnr_tpu.train.loop import train as jtrain
    from ycnr_tpu_torch.train.loop import train as ttrain

    out = str(tmp_path / which)
    if which == "jax":
        res = jtrain(cfg, ds, out_dir=out)
    else:
        res = ttrain(cfg, ds, out_dir=out, device="cpu")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return res, [json.loads(x) for x in f]


@pytest.mark.parametrize("algo,wire,residency", [
    ("als", "packed", "auto"), ("als", "packed", "host"),
    ("als", "rect", "device"), ("ials", "rect", "auto"),
    ("ials", "packed", "host")])
def test_train_loop_ooc_residency(tmp_path, algo, wire, residency):
    """train(ooc=True) on the CPU: the RMSE trajectory equals the port's
    resident train() bit for bit and the JAX package's train(ooc=True)
    within 1e-9; "auto" (everything fits) and "device" pin the wire and
    log the reference's ooc_residency event, "host" streams everything
    and logs none."""
    from ycnr_tpu.config import ALSConfig, DataConfig, IALSConfig, RunConfig
    from ycnr_tpu.data.dataset import load_dataset

    cfg = RunConfig(
        name="tiny", algorithm=algo,
        data=DataConfig(n_users=200, n_items=120, n_ratings=4000,
                        true_rank=4, seed=0, max_groups=4),
        als=ALSConfig(rank=6, lam=0.05, epochs=2, dtype="float64"),
        ials=IALSConfig(rank=6, lam=0.1, alpha=2.0, epochs=2,
                        dtype="float64"),
        ooc=True, ooc_wire=wire, ooc_residency=residency)
    ds = load_dataset(cfg.data, rank_hint=6)
    tr, trec = _runs(tmp_path, cfg, ds, "port")
    rr, _ = _runs(tmp_path, dataclasses.replace(cfg, ooc=False), ds,
                  "resident")
    jr, jrec = _runs(tmp_path, cfg, ds, "jax")
    assert tr.rmse_history == rr.rmse_history
    np.testing.assert_allclose(tr.rmse_history, jr.rmse_history, rtol=0,
                               atol=1e-9)
    assert torch.equal(tr.state.U, rr.state.U)
    ev = [x for x in trec if x.get("event") == "ooc_residency"]
    jev = [x for x in jrec if x.get("event") == "ooc_residency"]
    if residency == "host":
        assert ev == [] and jev == []
    else:
        assert len(ev) == 1 and ev[0]["hbm_pinned_bytes"] > 0
        assert ev[0]["streamed_bytes"] == 0
        assert {k: ev[0][k] for k in ("hbm_pinned_bytes", "streamed_bytes")} \
            == {k: jev[0][k] for k in ("hbm_pinned_bytes", "streamed_bytes")}


def test_train_ooc_refuses_what_the_reference_refuses():
    from ycnr_tpu_torch.config import RunConfig, SGDConfig
    from ycnr_tpu_torch.train.loop import train as ttrain

    for kw in (dict(ooc_wire="zip"), dict(ooc_residency="nvme")):
        with pytest.raises(ValueError, match="ooc_"):
            ttrain(RunConfig(ooc=True, **kw), device="cpu")
    for cfg in (RunConfig(algorithm="bpr", ooc=True),
                RunConfig(algorithm="sgd", sgd=SGDConfig(method="batched"),
                          ooc=True)):
        with pytest.raises(ValueError, match="als/ials"):
            ttrain(cfg, device="cpu")


def test_wire_stats(coo, layouts):
    u, _, _ = coo
    stats = tpacked.packed_stats(layouts[2], len(u))
    assert stats == jpacked.packed_stats(layouts[2], len(u))
    assert stats["rating_kind"] == "half"
    # u16 delta + i8 rating + block metadata: under 4 B/rating
    assert stats["wire_bytes_per_rating"] < 4.0
    assert 0 < stats["fill"] <= 1.0


def test_rect_memmap_roundtrip(layouts, tmp_path):
    """rect_from_packed(out_dir=...) memmaps lo/rat to disk; the memmap
    group equals the in-RAM expansion and the JAX package's, and streams
    through an epoch like any host group."""
    g = layouts[2][0]
    a = tpacked.rect_from_packed(g)
    b = tpacked.rect_from_packed(g, out_dir=str(tmp_path), gi=0)
    j = jpacked.rect_from_packed(g)
    assert isinstance(b.lo, np.memmap) and isinstance(b.rat, np.memmap)
    for name, x, y, z in zip(a._fields, a, b, j):
        if isinstance(x, np.ndarray):
            assert np.array_equal(x, np.asarray(y)), name
            assert np.array_equal(x, z), name
        else:
            assert x == y == z, name
    rest = tuple(tpacked.rect_from_packed(x) for x in layouts[2][1:])
    st_m = tooc.als_epoch_ooc(tstate(), (b,) + rest, layouts[3], LAM)
    st_a = tooc.als_epoch_ooc(tstate(), (a,) + rest, layouts[3], LAM)
    assert torch.equal(st_m.U, st_a.U) and torch.equal(st_m.V, st_a.V)


def test_stream_builder_bitwise(coo, layouts, tmp_path):
    """The portioned two-pass builder equals the in-RAM builder, in RAM
    and in memmaps, and the JAX package's portioned builder."""
    u, i, r = coo

    def portions():
        for s in range(0, len(u), 7_777):
            yield u[s:s + 7_777], i[s:s + 7_777], r[s:s + 7_777]

    jpk = jpacked.build_packed_stream(portions(), NU, NI,
                                      portions2=portions(), **BUILD)
    for out_dir in (None, str(tmp_path / "wire")):
        pk2 = tpacked.build_packed_stream(portions(), NU, NI,
                                          portions2=portions(),
                                          out_dir=out_dir, **BUILD)
        for g_p, g_q, g_j in zip(layouts[2], pk2, jpk, strict=True):
            for name, a, b, c in zip(g_p._fields, g_p, g_q, g_j):
                if isinstance(a, np.ndarray):
                    assert np.array_equal(a, np.asarray(b)), name
                    assert np.array_equal(a, c), name
                else:
                    assert a == b == c, name


def test_stream_builder_other_view(coo, layouts):
    u, i, r = coo

    def portions():
        yield u, i, r

    pk2 = tpacked.build_packed_stream(portions(), NI, NU,
                                      portions2=portions(), view="other",
                                      **BUILD)
    for g_p, g_q in zip(layouts[3], pk2, strict=True):
        for name, a, b in zip(g_p._fields, g_p, g_q):
            if isinstance(a, np.ndarray):
                assert np.array_equal(a, np.asarray(b)), name


def test_chunk_stream_on_the_cpu():
    """ChunkStream stages row slices and row gathers (in the given order)
    of several host arrays through its ring; the tensors it hands out
    hold the same values (uint16 as int16 bits), chunk after chunk, with
    the ring reused."""
    rng = np.random.default_rng(0)
    arrays = [rng.integers(0, 65536, (23, 5)).astype(np.uint16),
              rng.integers(-9, 9, (23, 3)).astype(np.int8),
              rng.standard_normal(23).astype(np.float32),
              rng.integers(0, 2**31, (23, 1, 2)).astype(np.int32)]
    order = rng.permutation(23)
    chunks = [((c0, "slice"), arrays, slice(c0, c0 + 4))
              for c0 in range(0, 23, 4)]
    chunks += [((c0, "take"), arrays, order[c0:c0 + 5])
               for c0 in range(0, 23, 5)]
    seen = 0
    with tooc.ChunkStream("cpu", prefetch=2) as stream:
        for (c0, kind), ts in tooc.stream_chunks(stream, chunks, 2):
            idx = (slice(c0, c0 + 4) if kind == "slice"
                   else order[c0:c0 + 5])
            for a, t in zip(arrays, ts):
                want = a[idx]
                got = t.numpy()
                if a.dtype == np.uint16:
                    got = got.view(np.uint16)
                assert got.dtype == want.dtype and np.array_equal(got, want)
            seen += 1
    assert seen == len(chunks) and stream.k == len(chunks)
    assert sum(b is not None for b in stream.bufs) == 3


def test_budget_model(layouts):
    """auto_wire_budget reserves the factors, one phase's bf16 copy, the
    largest block's working set, the in-flight chunks and 1 GB; the
    largest block's working set comes from the groups when given."""
    upk, ipk = layouts[2:]
    hbm = 20 * 10**9
    b = tooc.auto_wire_budget(NU, NI, K, hbm_bytes=hbm, groups=(upk, ipk))
    factors = (NU + NI + 2) * (K + 1) * 4
    bf16 = (NU + 1) * K * 2
    inflight = max(tooc._block_working_set(g, K, 2)
                   for g in (*upk, *ipk))
    assert hbm - b == (factors + bf16 + inflight
                       + 3 * tooc._CHUNK_TARGET_BYTES + 10**9)
    assert tooc.auto_wire_budget(NU, NI, K, hbm_bytes=hbm) == \
        hbm - (factors + bf16 + 1_500_000_000
               + 3 * tooc._CHUNK_TARGET_BYTES + 10**9)
    assert tooc.auto_wire_budget(NU, NI, K, hbm_bytes=10**9) == 0
    # wire-order storage sizes the factors from the tables' rows
    w = tooc.auto_wire_budget(NU, NI, K, hbm_bytes=hbm, storage="wire",
                              table_rows=(NU + 50, NI + 20))
    assert w == hbm - ((NU + NI + 72) * (K + 1) * 4 + (NU + 51) * K * 2
                       + 1_500_000_000 + 3 * tooc._CHUNK_TARGET_BYTES
                       + 10**9)


def test_device_stats_and_entry_points_without_a_card(layouts,
                                                      monkeypatch):
    """On the CPU the memory stats are empty (the budget assumes the JAX
    package's 15 GB); pinning with device=None needs a card."""
    assert tooc.device_hbm_stats("cpu") == {}
    assert tooc.device_hbm_bytes("cpu") == 15 * 10**9
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tooc.device_hbm_stats() == {}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tooc.wire_to_device(layouts[2], layouts[3])

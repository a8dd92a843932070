"""The port's compact SGD wire (``ops/sgd_wire.py``) and out-of-core
stream-SGD epochs (``models/sgd_stream.py``) against ``ycnr_tpu``: the
cases of ``tests/test_sgd_wire.py`` and the out-of-core cases of
``tests/test_sgd_stream.py``, each through both packages.

The wire equals the JAX package's array for array. Under one explicit
batch order the four stream-SGD forms (flat / compact x resident /
streamed from host memory) give the port's resident epoch bit for bit, as
the JAX package's four give its own, and each is within 1e-9 of the JAX
package's epoch in float64 (the port's parity tolerance: torch and XLA
sum in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ycnr_tpu.models import base as jbase
from ycnr_tpu.models import sgd_stream as jss
from ycnr_tpu.ops import sgd_wire as jwire
from ycnr_tpu_torch.data.synthetic import synthetic_ratings
from ycnr_tpu_torch.models import base as tbase
from ycnr_tpu_torch.models import sgd_stream as tss
from ycnr_tpu_torch.ops import sgd_wire as twire

torch.set_num_threads(1)

DT = torch.float64
NU, NI, NNZ, B, K = 90, 50, 1200, 64, 6
TOL = dict(rtol=1e-9, atol=1e-12)
FLAT = ("ul", "ib", "rb", "wu", "wi")


def _factors(nu=NU, ni=NI, k=K, seed=0):
    rng = np.random.default_rng(seed)
    U, V = np.zeros((nu + 1, k)), np.zeros((ni + 1, k))
    U[:nu] = rng.normal(0, 0.1, (nu, k))
    V[:ni] = rng.normal(0, 0.1, (ni, k))
    return U, V, np.zeros(nu + 1), np.zeros(ni + 1)


def tstate(mu=3.5, **kw):
    return tbase.state_from_numpy(*_factors(**kw), mu, device="cpu",
                                  dtype=DT)


def jstate(mu=3.5, **kw):
    return jbase.MFState(*(jnp.asarray(x, jnp.float64)
                           for x in (*_factors(**kw), mu)))


def _host_streams(grad_mode="capped", seed=3, nu=NU, ni=NI, nnz=NNZ,
                  **kw):
    """The port's and the JAX package's host stream of the same ratings
    (equal array for array)."""
    u, i, r = synthetic_ratings(nu, ni, nnz, true_rank=3, seed=seed, **kw)
    t, _ = tss.prepare_stream_sgd(u, i, r, B, nu, ni, seed=7, dtype=DT,
                                  grad_mode=grad_mode, device=False)
    j, _ = jss.prepare_stream_sgd(u, i, r, B, nu, ni, seed=7,
                                  dtype=jnp.float64, grad_mode=grad_mode,
                                  device=False)
    return t, j


def _resident(host):
    return host._replace(**{n: torch.as_tensor(getattr(host, n)).long()
                            if n in ("ul", "ib") else
                            torch.as_tensor(getattr(host, n))
                            for n in FLAT})


def assert_same_wire(a, b):
    for name, x, y in zip(a._fields, a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), name
        else:
            assert x == y, name


def assert_state(got, want):
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b)


def assert_near_jax(got, jgot):
    for a, b in zip(tbase.to_numpy(got)[:4], jgot[:4]):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


@pytest.mark.parametrize("grad_mode", ["capped", "mean", "sum"])
def test_roundtrip_exact(grad_mode):
    """compact_from_stream validates by decoding on the host (reaching the
    return is the round trip); the wire and its decode equal the JAX
    package's, and the wire is under half the flat stream's bytes."""
    t, j = _host_streams(grad_mode)
    comp = twire.compact_from_stream(t, NI)
    assert_same_wire(comp, jwire.compact_from_stream(j, NI))
    flat_bytes = sum(getattr(t, n).nbytes for n in FLAT + ("u_lo",))
    assert comp.nbytes < 0.5 * flat_bytes
    assert comp.rating_kind == "half"
    dec = twire.decode_compact(comp, np.float64)
    for name, got, want in zip(FLAT, dec, jwire.decode_compact(
            jwire.compact_from_stream(j, NI), np.float64)):
        assert np.array_equal(got, want), name
    np.testing.assert_array_equal(dec[1], t.ib)
    np.testing.assert_array_equal(dec[3], t.wu)


def test_roundtrip_raw_ratings():
    """Continuous ratings ride the f32 raw wire; truly-f64 ones refuse."""
    t, _ = _host_streams(rating_levels=False)
    comp = twire.compact_from_stream(t, NI)
    assert comp.rating_kind == "raw"
    bad = t._replace(rb=np.asarray(t.rb, np.float64) + np.float64(1e-12))
    with pytest.raises(ValueError, match="f32 raw wire"):
        twire.compact_from_stream(bad, NI)


def test_tall_tile_rides_u32():
    """tile > 65,536 widens the local-row column to u32; the port decodes
    its int32 bits."""
    t, _ = _host_streams()
    comp = twire.compact_from_stream(t._replace(tile=65537), NI)
    assert comp.ul.dtype == np.uint32
    assert twire.compact_from_stream(t, NI).ul.dtype == np.uint16
    pinned = twire.put_compact(comp, "cpu")
    assert pinned.ul.dtype == torch.int32
    ul = tss._decode_compact_batch(
        *(getattr(pinned, n)[0] for n in tss._COMPACT_NAMES), NI, 32,
        "capped", "half", DT)[0]
    assert torch.equal(ul, torch.as_tensor(t.ul[0]).long())


@pytest.mark.parametrize("grad_mode", ["capped", "sum"])
def test_pinned_epoch_bitwise(grad_mode):
    """The pinned-compact epoch equals the resident flat epoch bit for
    bit (the device decode feeds the same batch update), and the JAX
    package's pinned epoch within 1e-9."""
    t, j = _host_streams(grad_mode)
    comp = twire.put_compact(twire.compact_from_stream(t, NI), "cpu")
    assert twire.compact_resident(comp)
    nb = t.ul.shape[0]
    order = np.arange(nb)[::-1].copy()  # a nontrivial batch order
    ref = tss.sgd_stream_epoch(tstate(), *(getattr(_resident(t), n)
                                           for n in FLAT),
                               t.u_lo, order, 0.02, 0.01, t.tile)
    got = tss.sgd_stream_epoch_pinned(tstate(), comp, order, 0.02, 0.01)
    assert_state(got, ref)
    jgot = jss.sgd_stream_epoch_pinned(
        jstate(), jwire.put_compact(jwire.compact_from_stream(j, NI)),
        jnp.asarray(order), 0.02, 0.01)
    assert_near_jax(got, jgot)


def test_streamed_compact_epoch_bitwise():
    """The host-streamed compact epoch (chunks of 4 batches, a short last
    chunk) equals the pinned epoch under the same batch order."""
    t, j = _host_streams("capped")
    comp = twire.compact_from_stream(t, NI)
    nb = t.ul.shape[0]
    assert nb >= 5 and nb % 4
    order = np.random.default_rng(11).permutation(nb)
    got = tss._compact_epoch_ooc(tstate(), comp, order, 0.02, 0.01,
                                 chunk_batches=4)
    ref = tss.sgd_stream_epoch_pinned(tstate(),
                                      twire.put_compact(comp, "cpu"), order,
                                      0.02, 0.01)
    assert_state(got, ref)
    jgot = jss._compact_epoch_ooc(jstate(), jwire.compact_from_stream(j, NI),
                                  order, 0.02, 0.01, chunk_batches=4)
    assert_near_jax(got, jgot)


def test_trainer_dispatch_all_paths():
    """StreamSGD.epoch routes (format, residency) to the four epochs; all
    four give the same float64 factors over two epochs of one drawn
    order each, and each epoch's four forms stay within 1e-9 of the JAX
    package's resident epoch under the same orders."""
    t, j = _host_streams("capped")
    comp = twire.compact_from_stream(t, NI)
    forms = (_resident(t), t, twire.put_compact(comp, "cpu"), comp)
    tr = tss.StreamSGD(lam=0.02, lr=0.01, seed=4, grad_mode="capped")
    nb = t.ul.shape[0]
    orders = [np.random.default_rng(e).permutation(nb) for e in range(2)]
    outs = []
    for data in forms:
        st = tstate()
        for e in range(2):
            st = tr.epoch(st, data, e, order=orders[e])
        outs.append(st)
    for st in outs[1:]:
        assert_state(st, outs[0])
    jd = j._replace(**{n: jnp.asarray(getattr(j, n)) for n in
                       FLAT + ("u_lo",)})
    jst = jstate()
    for e in range(2):
        jst = jss.sgd_stream_epoch(jst, jd.ul, jd.ib, jd.rb, jd.wu, jd.wi,
                                   jd.u_lo, jnp.asarray(orders[e]), 0.02,
                                   tr.lr_at(e), j.tile)
    assert_near_jax(outs[0], jst)
    # drawn orders: the same draw for every form, so the same bits
    drawn = [tr.epoch(tstate(), data, 3) for data in forms]
    for st in drawn[1:]:
        assert_state(st, drawn[0])


def test_budget_model():
    b = twire.sgd_wire_budget(NU, NI, 64, hbm_bytes=15 * 10**9)
    assert b == jwire.sgd_wire_budget(NU, NI, 64, hbm_bytes=15 * 10**9)
    assert 0 < b < 15 * 10**9
    assert twire.sgd_wire_budget(NU, NI, 64, hbm_bytes=10**9) == 0
    assert twire.sgd_wire_budget(NU, NI, 64, device="cpu") == b


def test_nbytes_rate():
    """Capped mode lands in the 5-9 B/rating band (padding included),
    "sum" near 5 B; the byte counts equal the JAX package's, and a pinned
    wire counts the same bytes."""
    for gm, hi in (("capped", 10.0), ("sum", 6.0)):
        t, j = _host_streams(gm)
        comp = twire.compact_from_stream(t, NI)
        assert comp.nbytes == jwire.compact_from_stream(j, NI).nbytes
        assert comp.nbytes / comp.ul.size <= hi
        assert twire.put_compact(comp, "cpu").nbytes == comp.nbytes


def test_loop_integration(tmp_path):
    """train() with ooc=True and stream SGD builds the compact wire (the
    sgd_wire event), pins it under the budget ("auto") or streams it
    ("host"), and trains the same factors as the resident stream run;
    rmse_train falls."""
    import dataclasses
    import json
    import os

    from ycnr_tpu_torch.config import DataConfig, RunConfig, SGDConfig
    from ycnr_tpu_torch.train.loop import train

    cfg = RunConfig(
        name="sgdwire", algorithm="sgd",
        data=DataConfig(source="synthetic", n_users=NU, n_items=NI,
                        n_ratings=NNZ, seed=1),
        sgd=SGDConfig(rank=6, lr=0.02, epochs=3, batch_size=B,
                      method="stream", dtype="float64"),
        ooc=True, seed=0)
    runs = {}
    for name, c in (("auto", cfg), ("host", dataclasses.replace(
            cfg, ooc_residency="host")), ("resident", dataclasses.replace(
                cfg, ooc=False))):
        res = train(c, out_dir=str(tmp_path / name), device="cpu")
        with open(os.path.join(res.out_dir, "metrics.jsonl")) as f:
            runs[name] = (res, [json.loads(x) for x in f])
    for name, pinned in (("auto", True), ("host", False)):
        res, records = runs[name]
        wire = [r for r in records if r.get("event") == "sgd_wire"]
        assert len(wire) == 1 and wire[0]["format"] == "compact"
        assert wire[0]["hbm_pinned"] is pinned
        tr = [r["rmse_train"] for r in records if "rmse_train" in r]
        assert tr[-1] < tr[0]
        assert res.rmse_history == runs["resident"][0].rmse_history
        assert_state(res.state, runs["resident"][0].state)


def test_loop_falls_back_to_the_flat_stream(tmp_path):
    """A batch beyond the compact wire's u16 multiplicities logs the
    reference's sgd_wire_fallback and trains the flat host stream."""
    import json
    import os

    from ycnr_tpu_torch.config import DataConfig, RunConfig, SGDConfig
    from ycnr_tpu_torch.train.loop import train

    cfg = RunConfig(
        name="fallback", algorithm="sgd",
        data=DataConfig(source="synthetic", n_users=NU, n_items=NI,
                        n_ratings=NNZ, seed=1),
        sgd=SGDConfig(rank=4, lr=0.02, epochs=1, batch_size=70_000,
                      method="stream"),
        ooc=True, seed=0)
    res = train(cfg, out_dir=str(tmp_path), device="cpu")
    with open(os.path.join(res.out_dir, "metrics.jsonl")) as f:
        records = [json.loads(x) for x in f]
    ev = [r for r in records if r.get("event") == "sgd_wire_fallback"]
    assert len(ev) == 1 and "65536" in ev[0]["reason"]
    assert not [r for r in records if r.get("event") == "sgd_wire"]
    assert np.isfinite(res.rmse_history[-1])


def test_save_load_and_flat_from_compact(tmp_path):
    """The wire round-trips through one .npz and rebuilds the port's
    flat host stream, which trains as the original."""
    t, _ = _host_streams("capped")
    comp = twire.compact_from_stream(t, NI)
    path = str(tmp_path / "wire.npz")
    twire.save_compact(comp, path)
    assert_same_wire(twire.load_compact(path), comp)
    flat = twire.flat_from_compact(comp, np.float64)
    assert isinstance(flat, tss.StreamSGDData)
    for name in FLAT + ("u_lo",):
        np.testing.assert_array_equal(getattr(flat, name), getattr(t, name))
    with pytest.raises(ValueError, match="HOST"):
        twire.save_compact(twire.put_compact(comp, "cpu"), path)


def test_stream_ooc_epoch_bitwise_parity():
    """The out-of-core epoch over the host stream (chunks of 3 batches, a
    short last chunk) equals the resident epoch bit for bit over two
    epochs with a permuted order, and the JAX package's OOC epoch within
    1e-9."""
    nu, ni, k = 300, 80, 8
    u, i, r = synthetic_ratings(nu, ni, 4000, true_rank=3, seed=7)
    host, _ = tss.prepare_stream_sgd(u, i, r, B, nu, ni, seed=2, dtype=DT,
                                     device=False)
    dev, _ = tss.prepare_stream_sgd(u, i, r, B, nu, ni, seed=2, dtype=DT,
                                    device="cpu")
    jhost, _ = jss.prepare_stream_sgd(u, i, r, B, nu, ni, seed=2,
                                      dtype=jnp.float64, device=False)
    assert isinstance(host.ul, np.ndarray) and host.tile == dev.tile
    nb = dev.ul.shape[0]
    assert nb % 3
    order = np.random.default_rng(11).permutation(nb).astype(np.int32)
    mu = float(np.mean(r))
    ref, got = tstate(mu, nu=nu, ni=ni, k=k), tstate(mu, nu=nu, ni=ni, k=k)
    jgot = jstate(mu, nu=nu, ni=ni, k=k)
    for ep in range(2):
        lr = 0.01 * 0.9**ep
        ref = tss.sgd_stream_epoch(ref, dev.ul, dev.ib, dev.rb, dev.wu,
                                   dev.wi, dev.u_lo, order, 0.02, lr,
                                   dev.tile)
        got = tss.sgd_stream_epoch_ooc(got, host, order, 0.02, lr,
                                       chunk_batches=3)
        jgot = jss.sgd_stream_epoch_ooc(jgot, jhost, order, 0.02, lr,
                                        chunk_batches=3)
    assert_state(got, ref)
    assert_near_jax(got, jgot)


def test_stream_ooc_trainer_dispatch():
    """StreamSGD.epoch routes host data through the OOC epoch and keeps
    determinism (same seed and epoch: the same bits)."""
    nu, ni, k = 60, 30, 4
    u, i, r = synthetic_ratings(nu, ni, 700, true_rank=2, seed=4)
    data, _ = tss.prepare_stream_sgd(u, i, r, B, nu, ni, seed=1, dtype=DT,
                                     device=False)
    tr = tss.StreamSGD(lam=0.02, lr=0.02, seed=9)
    a = tr.epoch(tstate(nu=nu, ni=ni, k=k), data, 0)
    b = tr.epoch(tstate(nu=nu, ni=ni, k=k), data, 0)
    assert_state(a, b)
    assert not torch.equal(a.U, tstate(nu=nu, ni=ni, k=k).U)


def test_put_compact_needs_a_device(monkeypatch):
    t, _ = _host_streams()
    comp = twire.compact_from_stream(t, NI)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        twire.put_compact(comp)


def test_jax_forms_agree_with_each_other():
    """The reference's own four forms agree bit for bit on these inputs,
    so the port's single resident epoch is the one to hold them to."""
    t, j = _host_streams("capped")
    jc = jwire.compact_from_stream(j, NI)
    nb = j.ul.shape[0]
    order = np.random.default_rng(5).permutation(nb)
    jd = j._replace(**{n: jnp.asarray(getattr(j, n)) for n in
                       FLAT + ("u_lo",)})
    a = jss.sgd_stream_epoch(jstate(), jd.ul, jd.ib, jd.rb, jd.wu, jd.wi,
                             jd.u_lo, jnp.asarray(order), 0.02, 0.01,
                             j.tile)
    b = jss._compact_epoch_ooc(jstate(), jc, order, 0.02, 0.01)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    got = tss._compact_epoch_ooc(tstate(), twire.compact_from_stream(t, NI),
                                 order, 0.02, 0.01)
    assert_near_jax(got, a)

"""The port's shared-memory factor store (``serve/shm.py`` over
``csrc/shm_store.cc``): the cases of ``tests/test_shm_store.py`` through the
port, on the CPU, plus segments written by one package and read by the
other. The JAX package's library is compiled from its own source into a
temporary directory and handed to its loader, so nothing here depends on
``ycnr_tpu.native``'s shared build; a build that fails fails the test."""

import ctypes
import json
import os
import subprocess
import sys
import threading
import uuid

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ycnr_tpu import native as jnative
from ycnr_tpu.models.base import MFState as JState
from ycnr_tpu.serve import shm as jshm
from ycnr_tpu_torch.models.base import MFState, init_state
from ycnr_tpu_torch.native import get_shm_lib
from ycnr_tpu_torch.serve import shm as tshm
from ycnr_tpu_torch.serve.engine import Recommender
from ycnr_tpu_torch.serve.shm import (FactorShmReader, FactorShmWriter,
                                      ShmRecommender)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_jax_library(tmp_dir, stem: str) -> str:
    """``ycnr_tpu/native/<stem>.cc`` compiled with g++ into ``tmp_dir``."""
    src = os.path.join(REPO, "ycnr_tpu", "native", f"{stem}.cc")
    out = os.path.join(str(tmp_dir), f"libycnr_{stem}.so")
    res = subprocess.run(["g++", "-O3", "-shared", "-fPIC", src, "-o", out],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return out


@pytest.fixture(scope="module")
def jax_shm_path(tmp_path_factory):
    return build_jax_library(tmp_path_factory.mktemp("jaxshm"), "shm_store")


@pytest.fixture
def jax_shm(jax_shm_path, monkeypatch):
    """The JAX package's ``get_shm_lib`` serving the library built above."""
    monkeypatch.setitem(jnative._libs, "shm_store",
                        ctypes.CDLL(jax_shm_path))
    return jnative.get_shm_lib()


@pytest.fixture
def shm_name():
    name = f"/ycnr_ttest_{uuid.uuid4().hex[:12]}"
    yield name
    get_shm_lib().ycnr_shm_unlink(name.encode())


def _mk_state(n_users=13, n_items=9, rank=4, seed=3, mu=3.7):
    return init_state(n_users, n_items, rank, seed=seed, mu=mu,
                      device="cpu")


def test_roundtrip(shm_name):
    state = _mk_state()
    with FactorShmWriter(shm_name, 13, 9, 4) as w:
        w.publish(state, epoch=5)
        with FactorShmReader(shm_name) as r:
            assert (r.n_users, r.n_items, r.rank) == (13, 9, 4)
            got, epoch = r.read(device="cpu")
            assert epoch == 5
            for a, b in zip(got[:4], state[:4]):
                assert a.dtype == torch.float32 and a.device.type == "cpu"
                assert torch.equal(a, b)
            assert float(got.mu) == pytest.approx(3.7)


def test_epoch_peek_and_republish(shm_name):
    s1, s2 = _mk_state(seed=1), _mk_state(seed=2)
    with FactorShmWriter(shm_name, 13, 9, 4) as w:
        with FactorShmReader(shm_name) as r:
            assert r.epoch() == -2  # nothing published yet
            with pytest.raises(RuntimeError, match="nothing published"):
                r.read(device="cpu")
            w.publish(s1, 1)
            assert r.epoch() == 1
            w.publish(s2, 2)
            assert r.epoch() == 2
            got, e = r.read(device="cpu")
            assert e == 2 and torch.equal(got.U, s2.U)


def test_attach_missing_name():
    with pytest.raises(FileNotFoundError):
        FactorShmReader(f"/ycnr_nope_{uuid.uuid4().hex[:8]}")


def test_shm_recommender_hot_reload(shm_name):
    n_users, n_items, rank = 6, 20, 4
    train_u = np.array([0, 0, 1, 2, 3, 4, 5])
    train_i = np.array([1, 2, 3, 4, 5, 6, 7])
    s1 = _mk_state(n_users, n_items, rank, seed=10, mu=0.0)
    s2 = _mk_state(n_users, n_items, rank, seed=20, mu=0.0)
    with FactorShmWriter(shm_name, n_users, n_items, rank) as w:
        w.publish(s1, 1)
        rec = ShmRecommender(shm_name, train_u, train_i, device="cpu")
        assert rec.epoch == 1
        r1 = rec.recommend(0, 5)
        # the same request is cached until the trainer republishes
        np.testing.assert_array_equal(rec.recommend(0, 5), r1)
        w.publish(s2, 2)
        r2 = rec.recommend(0, 5)
        assert rec.epoch == 2
        expect = Recommender(s2, train_u, train_i).recommend(0, 5)
        np.testing.assert_array_equal(r2, expect)
        rec.close()


def test_publish_dim_mismatch_raises(shm_name):
    with FactorShmWriter(shm_name, 13, 9, 4) as w:
        with pytest.raises(ValueError, match="dims"):
            w.publish(_mk_state(rank=8), 1)


def test_writer_restart_same_dims_keeps_readers_live(shm_name):
    s1, s2 = _mk_state(seed=1), _mk_state(seed=2)
    with FactorShmWriter(shm_name, 13, 9, 4) as w1:
        w1.publish(s1, 1)
        with FactorShmReader(shm_name) as r:
            assert r.read(device="cpu")[1] == 1
            # the trainer restarts: same dims -> adopts the live segment
            with FactorShmWriter(shm_name, 13, 9, 4) as w2:
                w2.publish(s2, 2)
            got, e = r.read(device="cpu")
            assert e == 2 and torch.equal(got.U, s2.U)


def test_writer_restart_new_dims_isolates_old_readers(shm_name):
    with FactorShmWriter(shm_name, 13, 9, 4) as w1:
        w1.publish(_mk_state(), 1)
        with FactorShmReader(shm_name) as old:
            # dims changed -> a fresh segment; the old mapping stays intact
            with FactorShmWriter(shm_name, 20, 9, 8) as w2:
                w2.publish(_mk_state(20, 9, 8), 7)
                got, e = old.read(device="cpu")
                assert e == 1 and tuple(got.U.shape) == (14, 4)
                with FactorShmReader(shm_name) as new:
                    assert (new.n_users, new.rank) == (20, 8)
                    assert new.read(device="cpu")[1] == 7


def test_concurrent_publish_never_tears(shm_name):
    """Seqlock contract: while a writer republishes constantly, every reader
    snapshot is internally consistent; each publish writes uniform arrays
    (U == V == bu == bi == mu == epoch), so a mix of two is detectable."""
    n_users, n_items, rank = 64, 64, 16
    states = []
    for c in range(1, 6):
        U = torch.full((n_users + 1, rank), float(c))
        states.append(MFState(U, U, U[:, 0], U[:, 0], torch.tensor(float(c))))
    stop = threading.Event()
    with FactorShmWriter(shm_name, n_users, n_items, rank) as w:
        w.publish(states[0], 1)

        def writer():
            k = 0
            while not stop.is_set():
                k += 1
                w.publish(states[k % 5], k % 5 + 1)

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        try:
            with FactorShmReader(shm_name) as r:
                seen = set()
                for _ in range(100):
                    got, e = r.read(max_retries=10_000, device="cpu")
                    seen.add(e)
                    for arr in got[:4]:
                        assert bool((arr == float(e)).all()), "torn snapshot"
                    assert float(got.mu) == float(e)
        finally:
            stop.set()
            t.join(timeout=10)
        assert not t.is_alive()
        assert len(seen) > 1, "the writer never published in between"


_CHILD = r"""
import json, sys
import numpy as np
from ycnr_tpu_torch.serve.shm import FactorShmReader

with FactorShmReader(sys.argv[1]) as r:
    state, epoch = r.read(device="cpu")
    print(json.dumps({
        "epoch": epoch,
        "dims": [r.n_users, r.n_items, r.rank],
        "u_sum": float(state.U.double().sum()),
        "mu": float(state.mu),
    }))
"""


def test_cross_process_attach(shm_name, tmp_path):
    state = _mk_state(n_users=31, n_items=17, rank=8, seed=7, mu=1.25)
    with FactorShmWriter(shm_name, 31, 17, 8) as w:
        w.publish(state, 42)
        out = subprocess.run([sys.executable, "-c", _CHILD, shm_name],
                             capture_output=True, text=True, timeout=240,
                             env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
        assert out.returncode == 0, out.stderr
        got = json.loads(out.stdout.strip().splitlines()[-1])
        assert got["epoch"] == 42
        assert got["dims"] == [31, 17, 8]
        assert got["u_sum"] == pytest.approx(float(state.U.double().sum()),
                                             rel=1e-6)
        assert got["mu"] == pytest.approx(1.25)


def _train_cfg(m, name, tmp_path, **kw):
    return m.RunConfig(
        name="shmtest", algorithm="als",
        data=m.DataConfig(source="synthetic", n_users=40, n_items=24,
                          n_ratings=600, chunk_len=8),
        als=m.ALSConfig(rank=6, epochs=3, dtype="float64"),
        out_dir=str(tmp_path), checkpoint_every=0, log_train_rmse=False,
        publish_shm=name, **kw)


@pytest.mark.parametrize("fused_epochs", [1, 2])
def test_train_publishes_live_factors(shm_name, tmp_path, jax_shm,
                                      fused_epochs):
    """train(cfg publish_shm=...) leaves the last epoch in shm (after each
    epoch, or at fused-block ends) and a serving process can attach it;
    the factors equal those the JAX package's train() publishes from the
    same float64 run."""
    from ycnr_tpu import config as jconfig
    from ycnr_tpu.train.loop import train as jtrain
    from ycnr_tpu_torch import config as tconfig
    from ycnr_tpu_torch.train.loop import train as ttrain

    result = ttrain(_train_cfg(tconfig, shm_name, tmp_path / "t",
                               fused_epochs=fused_epochs), device="cpu")
    with FactorShmReader(shm_name) as r:
        got, epoch = r.read(device="cpu")
    assert epoch == 3
    assert torch.equal(got.U, result.state.U.float())
    jname = shm_name + "j"
    try:
        jtrain(_train_cfg(jconfig, jname, tmp_path / "j",
                          fused_epochs=fused_epochs))
        with FactorShmReader(jname) as r:
            want, jepoch = r.read(device="cpu")
    finally:
        get_shm_lib().ycnr_shm_unlink(jname.encode())
    assert jepoch == 3
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    rec = ShmRecommender(shm_name, result.dataset.train_u,
                         result.dataset.train_i, device="cpu")
    assert len(rec.recommend(0, 5)) == 5
    rec.close()


def test_publish_checkpoint_cli_path(shm_name, tmp_path):
    from ycnr_tpu_torch.serve.shm import publish_checkpoint
    from ycnr_tpu_torch.train.checkpoint import save_checkpoint

    state = _mk_state()
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, state, epoch=9)
    assert publish_checkpoint(ckpt, shm_name, device="cpu") == 9
    with FactorShmReader(shm_name) as r:
        got, e = r.read(device="cpu")
        assert e == 9 and torch.equal(got.V, state.V)


def test_second_live_writer_in_other_process_refused(shm_name):
    """Single-writer guard: while another process's writer is alive, create
    refuses (two writers on one seqlock could validate torn reads); after
    that process dies, the name is adoptable again."""
    child = subprocess.Popen(
        [sys.executable, "-c", f"""
import time
from ycnr_tpu_torch.serve.shm import FactorShmWriter
w = FactorShmWriter({shm_name!r}, 13, 9, 4)
print("ready", flush=True)
time.sleep(30)
"""], stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    try:
        assert child.stdout.readline().strip() == "ready"
        with pytest.raises(OSError, match="live writer"):
            FactorShmWriter(shm_name, 13, 9, 4)
    finally:
        child.kill()
        child.wait()
    # the killed child never cleared its pid; a dead owner is adoptable
    with FactorShmWriter(shm_name, 13, 9, 4) as w:
        w.publish(_mk_state(), 1)


def _jax_state(state: MFState) -> JState:
    return JState(*(jnp.asarray(x.numpy()) for x in state))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_segment_reads_across_the_packages(shm_name, jax_shm, writer):
    """A segment published by one package reads back bit-equal in the
    other: dims, epoch, U, V, bu, bi and mu (float32 in the segment)."""
    state = _mk_state(n_users=21, n_items=11, rank=5, seed=4, mu=2.5)
    state = state._replace(bu=torch.linspace(-1, 1, 22),
                           bi=torch.linspace(0, 2, 12))
    W, R = ((tshm.FactorShmWriter, jshm.FactorShmReader) if writer == "port"
            else (jshm.FactorShmWriter, tshm.FactorShmReader))
    with W(shm_name, 21, 11, 5) as w:
        w.publish(state if writer == "port" else _jax_state(state), 17)
        with R(shm_name) as r:
            assert (r.n_users, r.n_items, r.rank) == (21, 11, 5)
            assert r.epoch() == 17
            got, e = (r.read() if writer == "port"
                      else r.read(device="cpu"))
    assert e == 17
    for a, b in zip(got, state):
        a = np.asarray(a)
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b.numpy())


def test_reload_never_reuses_the_old_gram(shm_name):
    """The implicit fold-in caches V's Gram by tensor; after a hot reload
    a cold user is folded in against the new V, as a fresh Recommender on
    the new state folds it in."""
    n_users, n_items, rank = 30, 25, 4
    rng = np.random.default_rng(5)
    tu = rng.integers(0, n_users, 300)
    ti = rng.integers(0, n_items, 300)
    s1 = _mk_state(n_users, n_items, rank, seed=1, mu=0.0)
    s2 = _mk_state(n_users, n_items, rank, seed=2, mu=0.0)
    items, ratings = [1, 4, 9], [5.0, 3.0, 4.0]
    with FactorShmWriter(shm_name, n_users, n_items, rank) as w:
        w.publish(s1, 1)
        rec = ShmRecommender(shm_name, tu, ti, device="cpu")
        before = rec.engine.recommend_cold(items, ratings, n=6, alpha=10.0)
        w.publish(s2, 2)
        rec.refresh()
        after = rec.engine.recommend_cold(items, ratings, n=6, alpha=10.0)
        rec.close()
    fresh = Recommender(s2, tu, ti).recommend_cold(items, ratings, n=6,
                                                   alpha=10.0)
    np.testing.assert_array_equal(after, fresh)
    assert not np.array_equal(before, after)


def test_reader_and_recommender_default_to_the_card(shm_name, monkeypatch):
    """device=None means CUDA: without a card, read() and ShmRecommender
    raise instead of serving from the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with FactorShmWriter(shm_name, 13, 9, 4) as w:
        w.publish(_mk_state(), 1)
        with FactorShmReader(shm_name) as r:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                r.read()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ShmRecommender(shm_name, [0], [1])

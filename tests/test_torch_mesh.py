"""The port's mesh (``ycnr_tpu_torch.parallel.mesh``) on the CPU: the
collectives of a ``Mesh`` on gloo thread ranks, ``init_distributed``'s
explicit, environment and command-line forms (as
``tests/test_distributed_init.py`` pins the JAX package's), the backend
rules (NCCL needs a card a rank, and is never swapped for gloo) and the
guard that a collective one rank skips fails within its timeout."""

import time

import pytest
import torch
import torch.distributed as dist

from ycnr_tpu_torch.parallel import mesh as pmesh
from ycnr_tpu_torch.parallel.mesh import Mesh, run_ranks

torch.set_num_threads(1)


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_collectives_on_thread_ranks(world):
    def rank(m: Mesh):
        assert m.world == world and m.backend == "gloo"
        t = torch.full((3, 2), float(m.rank + 1), dtype=torch.float64)
        m.all_reduce_(t)
        got = m.all_gather(torch.tensor([m.rank, 10 * m.rank]))
        b = torch.tensor([7.0 if m.rank == 0 else -1.0])
        m.broadcast_(b)
        m.barrier()
        return t, [g.tolist() for g in got], b.item(), m.bytes_moved

    total = world * (world + 1) / 2
    for t, g, b, moved in run_ranks(rank, world):
        assert bool((t == total).all())
        assert g == [[r, 10 * r] for r in range(world)]
        assert b == 7.0
        assert moved == 48 + world * 16 + 4 + 4  # reduce, gather, bcast,
        #                                          barrier


def test_all_gather_keeps_dtype_and_shape():
    out = run_ranks(lambda m: m.all_gather(
        torch.arange(6, dtype=torch.int32).reshape(2, 3) + m.rank), 2)[1]
    assert [x.dtype for x in out] == [torch.int32] * 2
    assert torch.equal(out[1] - out[0], torch.ones(2, 3, dtype=torch.int32))


def test_a_rank_error_reaches_the_caller():
    def rank(m):
        if m.rank == 1:
            raise KeyError("rank 1 failed")
        return m.rank

    with pytest.raises(KeyError, match="rank 1 failed"):
        run_ranks(rank, 2, timeout=2)


def test_a_skipped_collective_fails_within_its_timeout():
    """Rank 1 holds its group open but never joins the all-reduce: rank
    0's collective raises after the 2 s timeout instead of hanging."""
    def rank(m):
        if m.rank == 1:
            time.sleep(4)
            return None
        t0 = time.time()
        with pytest.raises(RuntimeError):
            m.all_reduce_(torch.ones(4))
        return time.time() - t0

    waited = run_ranks(rank, 2, timeout=2)[0]
    assert 1.5 <= waited < 10


def test_run_ranks_is_gloo_only():
    with pytest.raises(ValueError, match="gloo"):
        run_ranks(lambda m: None, 2, backend="nccl")


def test_nccl_with_more_ranks_than_cards_raises(monkeypatch):
    """Two NCCL ranks on one card: the port's own error, naming
    --dist-backend gloo; nothing switches to gloo."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--dist-backend gloo"):
        pmesh.check_backend("nccl", 2, "cuda")
    pmesh.check_backend("nccl", 1, "cuda")  # one rank a card is fine
    pmesh.check_backend("gloo", 8, "cuda")  # gloo shares the card
    with pytest.raises(RuntimeError, match="--dist-backend gloo"):
        pmesh.spawn_ranks("os:getcwd", 2, backend="nccl", device="cuda")
    with pytest.raises(ValueError, match="gloo"):
        pmesh.check_backend("nccl", 1, "cpu")
    with pytest.raises(ValueError, match="'nccl' or 'gloo'"):
        pmesh.check_backend("mpi", 1, "cpu")


def test_train_refuses_nccl_beyond_the_cards(monkeypatch):
    import dataclasses

    from ycnr_tpu_torch.config import MeshConfig, get_preset
    from ycnr_tpu_torch.train.loop import train

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cfg = get_preset("ml100k-als")
    cfg = dataclasses.replace(
        cfg, mesh=MeshConfig(n_shards=2), out_dir=None,
        data=dataclasses.replace(cfg.data, source="synthetic", n_users=30,
                                 n_items=20, n_ratings=300))
    with pytest.raises(RuntimeError, match="--dist-backend gloo"):
        train(cfg, device="cuda", backend="nccl")


def test_default_backend_follows_the_device():
    assert pmesh.default_backend("cpu") == "gloo"
    assert pmesh.default_backend(None) == "nccl"
    assert pmesh.default_backend("cuda:1") == "nccl"


def test_rank_device(monkeypatch):
    assert pmesh.rank_device(3, "cpu") == torch.device("cpu")
    assert pmesh.rank_device(0, "cuda:1") == torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pmesh.rank_device(3) == torch.device("cuda", 1)
    assert pmesh.rank_device(2, "cuda") == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmesh.rank_device(0)


@pytest.fixture
def captured(monkeypatch):
    calls = {}

    def fake_init(backend, **kw):
        calls.update(backend=backend, **kw)

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    monkeypatch.setattr(dist, "get_rank", lambda *a, **k: 2)
    return calls


def test_init_distributed_explicit(captured):
    assert pmesh.init_distributed("10.0.0.1:1234", 4, 2,
                                  device="cpu") == 2
    assert captured == {"backend": "gloo",
                        "init_method": "tcp://10.0.0.1:1234",
                        "world_size": 4, "rank": 2}


def test_init_distributed_from_the_environment(captured):
    """No arguments: torchrun's variables (env://), NCCL for the card."""
    pmesh.init_distributed()
    assert captured == {"backend": "nccl", "init_method": "env://"}


def test_init_distributed_named_backend(captured):
    pmesh.init_distributed("h:1", 2, 0, backend="gloo")
    assert captured["backend"] == "gloo"


def test_make_mesh_needs_a_group_of_its_size(monkeypatch):
    with pytest.raises(RuntimeError, match="init_distributed"):
        pmesh.make_mesh(2)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 3)
    monkeypatch.setattr(dist, "get_rank", lambda *a, **k: 1)
    monkeypatch.setattr(dist, "get_backend", lambda *a, **k: "gloo")
    with pytest.raises(ValueError, match="asked for 2 shards"):
        pmesh.make_mesh(2, device="cpu")
    m = pmesh.make_mesh(3, device="cpu")
    assert (m.rank, m.world, m.device.type, m.backend) == (1, 3, "cpu",
                                                           "gloo")


def test_sharded_train_and_tune_without_a_card_say_so(monkeypatch):
    """device=None means the card for the sharded paths too: without one
    they raise the port's device message before starting any rank."""
    import dataclasses

    from ycnr_tpu_torch.config import MeshConfig, get_preset
    from ycnr_tpu_torch.train.loop import train
    from ycnr_tpu_torch.train.tune import tune

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(get_preset("ml100k-als"),
                              mesh=MeshConfig(n_shards=2), out_dir=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tune(cfg, lams=[0.05])

"""The port's mesh: one process (or thread) per rank on ``torch.distributed``
(counterpart of ``ycnr_tpu/parallel/mesh.py``).

The JAX package runs a mesh as one controller over many devices
(``shard_map``, ``lax.psum``). PyTorch's idiom is one process per rank, so
every sharded function of the port runs on every rank and works on that
rank's slice. A ``Mesh`` holds the rank, the world size, the rank's device,
the backend and its own process group, and has the three collectives the
sharded code needs as methods; no sharded function touches the global
default group. The same code then runs

* as D processes under a launcher (``torchrun``'s environment, or
  ``init_distributed`` with an explicit address: the CLI's
  ``--distributed``);
* as D local processes that ``spawn_ranks`` starts (``train()`` and
  ``tune()`` do so for ``mesh.n_shards > 1`` outside any process group);
* as D threads of one process, each holding a ``ProcessGroupGloo`` over one
  shared ``HashStore`` (``run_ranks``, for the tests).

The backend is named by the caller and never switched: None means NCCL on
the card and gloo for ``device="cpu"``. NCCL needs a card per rank; asked
for more ranks than there are cards it raises and names
``--dist-backend gloo``, which puts several ranks on one card (their
collectives then move through host memory).
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

TEST_TIMEOUT_S = 60  # run_ranks' default: a hung collective fails its test


class Mesh:
    """This rank's view of a 1-D mesh: ``rank`` of ``world`` on ``device``,
    with ``group`` (a ``ProcessGroup``) carrying the collectives."""

    def __init__(self, rank: int, world: int, device, backend: str, group):
        self.rank = int(rank)
        self.world = int(world)
        self.device = torch.device(device)
        self.backend = backend
        self.group = group
        self.bytes_moved = 0  # payload bytes through the collectives
        self.collective_s = 0.0  # host seconds spent in them
        # timed: synchronize the device around each collective, so that
        # collective_s is the collectives' own time (NCCL's wait() does
        # not block the host); off by default
        self.timed = False

    def __repr__(self):
        return (f"Mesh(rank={self.rank}, world={self.world}, "
                f"device={self.device}, backend={self.backend!r})")

    def _run(self, start, nbytes: int):
        """Start a collective (``start()`` returns its work) and wait."""
        sync = self.timed and self.device.type == "cuda"
        if sync:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        start().wait()
        if sync:
            torch.cuda.synchronize(self.device)
        self.collective_s += time.perf_counter() - t0
        self.bytes_moved += int(nbytes)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns ``t``. Over NCCL the
        sum runs on the collective's stream and ``wait`` orders the current
        stream after it (the host does not block). A world of one still
        makes the call (a real NCCL call at D = 1)."""
        self._run(lambda: self.group.allreduce([t]),
                  t.numel() * t.element_size())
        return t

    def all_gather(self, t: torch.Tensor) -> list:
        """Every rank's ``t`` (equal shapes), in rank order."""
        t = t.contiguous()
        outs = [torch.empty_like(t) for _ in range(self.world)]
        self._run(lambda: self.group.allgather([outs], [t]),
                  self.world * t.numel() * t.element_size())
        return outs

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` of rank ``src`` on every rank, in place."""
        opts = dist.BroadcastOptions()
        opts.rootRank = int(src)
        self._run(lambda: self.group.broadcast([t], opts),
                  t.numel() * t.element_size())
        return t

    def barrier(self):
        self.all_reduce_(torch.zeros(1, device=self.device))


def collective_check(mesh: Mesh) -> dict:
    """A rank's check of the three collectives on tensors of its device
    (the first thing to run on a new backend / device pairing): returns
    what it saw; every rank's sums and lists must come out the same."""
    r, w = mesh.rank, mesh.world
    t = torch.full((5,), float(r + 1), device=mesh.device)
    mesh.all_reduce_(t)
    got = mesh.all_gather(torch.arange(3, device=mesh.device) + r)
    b = torch.tensor([3.0 if r == 0 else 0.0], device=mesh.device)
    mesh.broadcast_(b)
    ok = (t.tolist() == [w * (w + 1) / 2] * 5
          and [x.tolist() for x in got] == [[q, q + 1, q + 2]
                                            for q in range(w)]
          and b.item() == 3.0
          and all(x.device == mesh.device for x in (t, b, *got)))
    return {"ok": ok, "backend": mesh.backend, "device": str(mesh.device),
            "world": w}


def default_backend(device) -> str:
    """The backend a caller gets when it names none: NCCL on the card,
    gloo on the CPU."""
    return "gloo" if torch.device(device or "cuda").type == "cpu" else "nccl"


def check_backend(backend: str, world: int, device):
    """NCCL needs a card a rank: refuse, naming the way out, rather than
    switch to gloo."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    if backend == "nccl":
        if torch.device(device or "cuda").type == "cpu":
            raise ValueError("NCCL runs on CUDA devices; a CPU run takes "
                             "--dist-backend gloo")
        cards = torch.cuda.device_count()
        if world > cards:
            raise RuntimeError(
                f"NCCL needs one card per rank: {world} ranks, {cards} "
                f"card(s) visible. Put several ranks on one card with "
                f"--dist-backend gloo (backend='gloo')")


def rank_device(rank: int, device=None) -> torch.device:
    """Rank r's device: ``device`` when it names one (``"cpu"``,
    ``"cuda:1"``), else ``cuda:{r % device_count}``."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' for a CPU run")
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_mesh(n_shards: Optional[int] = None, device=None) -> Mesh:
    """This process's ``Mesh`` over the default process group (joined by
    ``init_distributed``, torchrun or ``spawn_ranks``). Raises unless that
    group has ``n_shards`` ranks (None: any)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "init_distributed() first (or run under "
                           "torchrun / spawn_ranks)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_shards is not None and int(n_shards) != world:
        raise ValueError(f"asked for {n_shards} shards, the process group "
                         f"has {world} ranks")
    backend = str(dist.get_backend())
    dev = rank_device(rank, device)
    check_backend(backend, world, dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(rank, world, dev, backend, dist.group.WORLD)


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device=None) -> int:
    """Join a multi-process job and return this process's rank.

    With a coordinator (``HOST:PORT``) the group meets at
    ``tcp://HOST:PORT`` with the given world size and rank; without one it
    reads torchrun's environment (``env://``: ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). ``backend`` None: NCCL on
    the card, gloo for ``device="cpu"``."""
    kw = {}
    if coordinator is not None:
        kw["init_method"] = f"tcp://{coordinator}"
    else:
        kw["init_method"] = "env://"
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    dist.init_process_group(backend or default_backend(device), **kw)
    return dist.get_rank()


def run_ranks(fn: Callable, world: int, backend: str = "gloo",
              device="cpu", timeout: float = TEST_TIMEOUT_S) -> list:
    """``fn(mesh)`` on ``world`` thread ranks of this process, each with a
    ``ProcessGroupGloo`` over one shared ``HashStore``; returns the ranks'
    results in rank order and re-raises the first rank's exception. Every
    collective fails after ``timeout`` seconds instead of hanging (the
    tests' guard). gloo only: NCCL wants a process a card."""
    if backend != "gloo":
        raise ValueError("run_ranks runs gloo thread ranks only")
    store = dist.HashStore()
    prefix = f"run_ranks/{time.monotonic_ns()}"
    results, errors = [None] * world, [None] * world
    td = datetime.timedelta(seconds=timeout)

    def body(r):
        try:
            pg = dist.ProcessGroupGloo(dist.PrefixStore(prefix, store), r,
                                       world, td)
            results[r] = fn(Mesh(r, world, device, "gloo", pg))
        except BaseException as e:  # reported in the caller's thread
            errors[r] = e

    threads = [threading.Thread(target=body, args=(r,), daemon=True)
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None:
            raise e
    return results


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _package_root() -> str:
    import ycnr_tpu_torch

    return os.path.dirname(os.path.dirname(
        os.path.abspath(ycnr_tpu_torch.__file__)))


def spawn_ranks(target: str, world: int, *, backend: Optional[str] = None,
                device=None, arrays: Optional[dict] = None,
                kwargs: Optional[dict] = None,
                timeout: Optional[float] = None):
    """Run ``target`` (``"module:function"``) as ``world`` local rank
    processes and return rank 0's result.

    Each rank is ``python -m ycnr_tpu_torch.parallel.rank_main``: it joins
    one process group at ``tcp://127.0.0.1:<free port>`` (``backend``
    None: NCCL on the card, gloo for ``device="cpu"``), builds its
    ``Mesh`` on ``rank_device(rank, device)`` and calls
    ``function(mesh, **kwargs, **arrays)``, the arrays opened with
    ``np.load(mmap_mode="r")`` from one temporary ``.npy`` set that this
    process writes once (an ``arrays`` value that is a path names an
    ``.npy`` file already written). Rank 0 inherits this process's stdout and
    stderr; the others write theirs to files, whose tail is raised with
    the error if a rank fails. A rank that fails ends the others."""
    backend = backend or default_backend(device)
    check_backend(backend, world, device)
    arrays = arrays or {}
    with tempfile.TemporaryDirectory(prefix="ycnr_ranks_") as tmp:
        names = {}
        for k, a in arrays.items():
            if isinstance(a, str):  # an .npy file the caller wrote
                names[k] = a
                continue
            path = os.path.join(tmp, f"{k}.npy")
            np.save(path, np.ascontiguousarray(a))
            names[k] = path
        spec = {"target": target, "world": int(world), "backend": backend,
                "device": None if device is None else str(device),
                "init": f"tcp://127.0.0.1:{_free_port()}",
                "timeout": timeout, "kwargs": kwargs or {},
                "arrays": names,
                "result": os.path.join(tmp, "result.pkl")}
        with open(os.path.join(tmp, "spec.pkl"), "wb") as f:
            pickle.dump(spec, f)
        env = dict(os.environ)
        root = _package_root()
        env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"]
                                    if env.get("PYTHONPATH") else "")
        procs, logs = [], []
        for r in range(world):
            log = None if r == 0 else open(
                os.path.join(tmp, f"rank{r}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "ycnr_tpu_torch.parallel.rank_main",
                 tmp, str(r)], env=env, stdout=log,
                stderr=subprocess.STDOUT if log else None))
        failed = None
        try:
            while True:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    failed = bad[0]
                    break
                if all(c == 0 for c in codes):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for log in logs:
                if log is not None:
                    log.close()
        if failed is not None:
            tail = ""
            if failed > 0:
                with open(os.path.join(tmp, f"rank{failed}.log")) as f:
                    tail = f.read()[-4000:]
            raise RuntimeError(
                f"rank {failed} of {world} exited with "
                f"{procs[failed].returncode}" + (f":\n{tail}" if tail else
                                                 " (its log is above)"))
        with open(spec["result"], "rb") as f:
            return pickle.load(f)

"""Cross-process factor sharing over POSIX shared memory (counterpart of
``ycnr_tpu/serve/shm.py``).

A trainer publishes its factors into a named segment (``FactorShmWriter``)
and any number of serving processes attach and snapshot them
(``FactorShmReader``): no file I/O, no torn reads (the seqlock of
``csrc/shm_store.cc``, the JAX package's ``native/shm_store.cc`` byte for
byte, so a segment written by either package is read by the other), and
an epoch counter for staleness checks. ``ShmRecommender`` wires this into
the serving facade: each request peeks the epoch and hot-reloads the
factors (and moves the rec cache to the new epoch) when the trainer has
republished.

The segment holds float32 host arrays in the padded layout. A publish
copies each of U, V, bu and bi from the device to the host once; a read
copies the snapshot into host arrays and lands them on the reader's device
(the card unless ``device="cpu"``).

A reload swaps in new tensors (``Recommender.update_state``). The
implicit fold-in keeps its base Gram in ``serve/fold_in._GRAM_CACHE``,
keyed by the tensor V and its version, so a reloaded state never meets the
Gram of the V it replaced. That cache holds up to 8 superseded V alive
until it clears: 8 x 6.8 MB of the card's memory at the ML-20M catalog,
rank 64.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ycnr_tpu_torch import resolve_device
from ycnr_tpu_torch.models.base import MFState, state_from_numpy
from ycnr_tpu_torch.native import get_shm_lib
from ycnr_tpu_torch.serve.engine import Recommender


def shm_available() -> bool:
    return get_shm_lib() is not None


def _f32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _host_f32(t: torch.Tensor) -> np.ndarray:
    """One device-to-host copy into a contiguous float32 array."""
    return t.detach().to(device="cpu", dtype=torch.float32).contiguous() \
        .numpy()


def _lib():
    lib = get_shm_lib()
    if lib is None:
        raise RuntimeError("native shm library unavailable (no g++?)")
    return lib


class FactorShmWriter:
    """Trainer side: create the named segment and publish states into it."""

    def __init__(self, name: str, n_users: int, n_items: int, rank: int):
        lib = _lib()
        self._lib = lib
        self.name = name
        self.n_users, self.n_items, self.rank = n_users, n_items, rank
        self._h = lib.ycnr_shm_create(name.encode(), n_users, n_items, rank)
        if not self._h:
            owner = int(lib.ycnr_shm_busy_owner())
            if owner:
                raise OSError(
                    f"shm store {name!r} is owned by live writer pid "
                    f"{owner}; if that process is not a trainer (pid "
                    f"recycled after a crash), remove the stale segment "
                    f"with FactorShmWriter.unlink / shm_unlink({name!r}) "
                    f"and retry")
            raise OSError(f"shm_open/mmap failed for {name!r}")

    def publish(self, state: MFState, epoch: int):
        if not self._h:  # ctypes would pass NULL -> native deref -> segfault
            raise ValueError(f"shm writer {self.name!r} is closed")
        if (state.n_users, state.n_items, state.rank) != (
                self.n_users, self.n_items, self.rank):
            raise ValueError(
                f"state dims (users={state.n_users}, items={state.n_items}, "
                f"rank={state.rank}) != segment dims ({self.n_users}, "
                f"{self.n_items}, {self.rank})")
        U, V, bu, bi = (_host_f32(t) for t in state[:4])
        self._lib.ycnr_shm_publish(self._h, int(epoch), float(state.mu),
                                   _f32ptr(U), _f32ptr(V), _f32ptr(bu),
                                   _f32ptr(bi))

    def close(self):
        if self._h:
            self._lib.ycnr_shm_detach(self._h)
            self._h = None

    def unlink(self):
        """Remove the segment name (mappings stay valid until detached)."""
        self._lib.ycnr_shm_unlink(self.name.encode())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FactorShmReader:
    """Serving side: attach by name, snapshot factors, peek staleness."""

    def __init__(self, name: str):
        lib = _lib()
        self._lib = lib
        self.name = name
        self._h = lib.ycnr_shm_attach(name.encode())
        if not self._h:
            raise FileNotFoundError(f"no factor store at shm name {name!r}")
        dims = (ctypes.c_int64 * 3)()
        lib.ycnr_shm_dims(self._h, dims)
        self.n_users, self.n_items, self.rank = (int(dims[0]), int(dims[1]),
                                                 int(dims[2]))

    def epoch(self) -> int:
        """Last published epoch (-1 if a publish is in flight, -2 if none)."""
        if not self._h:
            raise ValueError(f"shm reader {self.name!r} is closed")
        return int(self._lib.ycnr_shm_epoch(self._h))

    def read(self, max_retries: int = 64, device=None):
        """Consistent snapshot -> (MFState on ``device``, epoch). ``device``
        None means the card and raises without one. Raises if the writer
        republishes faster than we can copy for max_retries attempts, or
        if nothing has been published yet."""
        device = resolve_device(device, "FactorShmReader.read()")
        if not self._h:  # ctypes would pass NULL -> native deref -> segfault
            raise ValueError(f"shm reader {self.name!r} is closed")
        U = np.empty((self.n_users + 1, self.rank), np.float32)
        V = np.empty((self.n_items + 1, self.rank), np.float32)
        bu = np.empty(self.n_users + 1, np.float32)
        bi = np.empty(self.n_items + 1, np.float32)
        mu = ctypes.c_double()
        e = int(self._lib.ycnr_shm_read(self._h, _f32ptr(U), _f32ptr(V),
                                        _f32ptr(bu), _f32ptr(bi),
                                        ctypes.byref(mu), max_retries))
        if e == -2:
            raise RuntimeError(f"shm store {self.name!r}: nothing published")
        if e < 0:
            raise RuntimeError(f"shm store {self.name!r}: torn reads "
                               f"exceeded {max_retries} retries")
        return state_from_numpy(U, V, bu, bi, np.float32(mu.value),
                                device=device), e

    def close(self):
        if self._h:
            self._lib.ycnr_shm_detach(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ShmRecommender:
    """A Recommender whose factors live in the shared segment: hot-reloads
    (and moves the cache to the new epoch) whenever the trainer publishes
    a newer epoch. ``device`` None means the card and raises without one."""

    def __init__(self, name: str, train_u, train_i, cache=None, device=None):
        self.device = resolve_device(device, "ShmRecommender")
        self.reader = FactorShmReader(name)
        state, self._epoch = self.reader.read(device=self.device)
        self._rec = Recommender(state, train_u, train_i, cache=cache)
        self._adopt_epoch()

    def _adopt_epoch(self):
        # a cross-process ShmRecCache keys entries by the published factor
        # epoch, so the whole fleet shares (and invalidates) together
        if hasattr(self._rec.cache, "set_epoch"):
            self._rec.cache.set_epoch(self._epoch + 1)

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def engine(self) -> Recommender:
        """The wrapped Recommender (serve/server.py refreshes under its own
        lock, then reads through this without re-refreshing)."""
        return self._rec

    def refresh(self):
        """Pick up a newer published epoch (recommend/recommend_batch call
        this automatically; external state consumers should too)."""
        e = self.reader.epoch()
        if e >= 0 and e != self._epoch:
            state, self._epoch = self.reader.read(device=self.device)
            self._rec.update_state(state)
            self._adopt_epoch()

    def recommend(self, user_id: int, n: int = 10, exclude=None):
        self.refresh()
        return self._rec.recommend(user_id, n, exclude=exclude)

    def recommend_batch(self, user_ids, n: int = 10):
        self.refresh()
        return self._rec.recommend_batch(user_ids, n)

    def predict(self, user_id: int, item_ids):
        self.refresh()
        return self._rec.predict(user_id, item_ids)

    def close(self):
        self.reader.close()


def publish_checkpoint(ckpt_dir: str, name: str, device=None) -> int:
    """Load a checkpoint (on ``device``, the card unless ``"cpu"``) and
    publish it into shm; returns the epoch. The CLI ``publish`` command:
    boots a serving fleet from durable storage."""
    from ycnr_tpu_torch.train.checkpoint import load_checkpoint

    state, manifest = load_checkpoint(ckpt_dir, device=device)
    w = FactorShmWriter(name, state.n_users, state.n_items, state.rank)
    try:
        w.publish(state, manifest["epoch"])
    finally:
        w.close()
    return int(manifest["epoch"])

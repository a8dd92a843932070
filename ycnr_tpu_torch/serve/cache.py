"""Recommendation caches (counterpart of ``ycnr_tpu/serve/cache.py``,
whose package imports JAX). Two implementations of one contract
(get / put / put_if / invalidate by user):

* ``RecCache``: process-local LRU with optional TTL, internally locked so
  concurrent serving threads can share one cache.
* ``ShmRecCache``: a cross-process cache over POSIX shared memory
  (``csrc/shm_cache.cc``, the JAX package's ``native/shm_cache.cc`` byte
  for byte): a fleet of serving processes attached to one factor store
  shares computed top-N lists. Entries are stamped with the factor epoch
  they were computed from, so a republish invalidates the whole shared
  cache implicitly. A segment and its entries are the JAX package's, so
  processes of either package share one cache; its ``put_if`` is also
  atomic against an epoch change, which the JAX package's is not.
"""

from __future__ import annotations

import ctypes
import threading
import time
from collections import OrderedDict
from typing import Hashable, Optional

import numpy as np

from ycnr_tpu_torch.native import get_cache_lib


class RecCache:
    def __init__(self, capacity: int = 100_000, ttl_s: Optional[float] = None):
        self.capacity = capacity
        self.ttl_s = ttl_s
        self._d: OrderedDict[Hashable, tuple] = OrderedDict()
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0

    def get(self, key):
        with self._lock:
            item = self._d.get(key)
            if item is None:
                self.misses += 1
                return None
            value, ts = item
            if self.ttl_s is not None and time.time() - ts > self.ttl_s:
                del self._d[key]
                self.misses += 1
                return None
            self._d.move_to_end(key)
            self.hits += 1
            return value

    def put(self, key, value) -> bool:
        return self.put_if(key, value, lambda: True)

    def put_if(self, key, value, cond) -> bool:
        """Insert only if ``cond()`` still holds, atomically with respect
        to every other cache operation (the engine's version guard)."""
        with self._lock:
            if not cond():
                return False
            self._d[key] = (value, time.time())
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)
            return True

    def invalidate(self, key=None):
        """Drop everything (key=None), one exact key, or every tuple key
        whose first element is ``key``: all of one user's ``(user_id, n)``
        entries. The engine's ``("pop", ...)`` and ``("sim", ...)`` entries
        start with a string, so a user id never reaches them."""
        with self._lock:
            if key is None:
                self._d.clear()
                return
            self._d.pop(key, None)
            for k in [k for k in self._d
                      if isinstance(k, tuple) and k and k[0] == key]:
                del self._d[k]

    def invalidate_popular(self):
        """Drop every ("pop", ...) entry — the engine calls this when the
        base item counts change (online-update compaction), which per-user
        invalidation cannot reach."""
        with self._lock:
            for k in [k for k in self._d
                      if isinstance(k, tuple) and k and k[0] == "pop"]:
                del self._d[k]

    def __len__(self):
        return len(self._d)


def shm_cache_available() -> bool:
    return get_cache_lib() is not None


class ShmRecCache:
    """Cross-process top-N cache (drop-in for RecCache in the serving
    engine). Keys are the engine's (user_id, n) tuples; values are int32
    item arrays. All entries are implicitly versioned by ``epoch`` — set
    it to the shm factor store's published epoch (ShmRecommender does) so
    a republish makes every stale entry miss. ``epoch`` must be >= 1
    (slot zero-state protection).

    invalidate() only has to bump the local epoch view: per-key deletion
    is unnecessary because lookups are (key, epoch)-exact.

    put_if is atomic with respect to this process's invalidate,
    invalidate_popular and set_epoch (one lock, as RecCache's): a list
    whose version check passed is filed before a republish moves the epoch
    or an online update writes its tombstones, never after them. The JAX
    package's copy checks, then reads the epoch to write under, so a
    republish in between files a list of the old factors under the new
    epoch.
    """

    N_MAX = 64

    def __init__(self, name: str, capacity: int = 1 << 16, epoch: int = 1):
        lib = get_cache_lib()
        if lib is None:
            raise RuntimeError("native shm cache unavailable (no g++?)")
        if capacity & (capacity - 1):
            raise ValueError("capacity must be a power of two")
        self._lib = lib
        self.name = name
        self._h = lib.ycnr_cache_create(name.encode(), capacity, self.N_MAX)
        if not self._h:
            raise OSError(
                f"shm cache {name!r}: create/attach failed (existing "
                f"segment with different dims? unlink it first)")
        # effective entry epoch = base (the PUBLISHED factor epoch, shared
        # by the whole fleet) * 2^20 + local bump count — full-cache
        # invalidate() bumps locally without ever colliding with a future
        # published epoch's entries
        self._base = int(epoch)
        self._bump = 0
        if self._base < 1:
            raise ValueError("epoch must be >= 1")
        self.hits = 0
        self.misses = 0
        self._lock = threading.RLock()

    @property
    def epoch(self) -> int:
        return self._base * (1 << 20) + self._bump

    def set_epoch(self, epoch: int):
        """Adopt a newly PUBLISHED factor epoch (fleet-wide key space)."""
        if epoch < 1:
            raise ValueError("epoch must be >= 1")
        with self._lock:
            self._base = int(epoch)
            self._bump = 0

    # key-space namespaces above the (user << 16 | n) plane: (tag, id, n,
    # variant) tuples from engine.similar / engine.popular
    _NS = {("sim", "cosine"): 1, ("sim", "dot"): 2, ("pop", "count"): 3}

    @classmethod
    def _key(cls, key) -> int:
        if isinstance(key[0], str):  # ("sim"|"pop", id, n, variant)
            tag, ident, n, variant = key
            ns = cls._NS[(tag, variant)]
            if not 0 <= int(ident) < (1 << 40):
                # ids >= 2^40 would alias across the ns<<56 namespaces
                raise ValueError(f"cache id {ident} out of the 40-bit "
                                 "packed-key range")
            return (ns << 56) | (int(ident) << 16) | (int(n) & 0xFFFF)
        user, n = key
        if not 0 <= int(user) < (1 << 40):
            # a user id >= 2^40 would collide with the sim/pop planes and
            # silently serve a similarity list as that user's recs
            raise ValueError(f"cache user id {user} out of the 40-bit "
                             "packed-key range")
        return (int(user) << 16) | (int(n) & 0xFFFF)

    @staticmethod
    def _n_of(key) -> int:
        return int(key[2] if isinstance(key[0], str) else key[1])

    def get(self, key):
        if not self._h:
            raise ValueError(f"shm cache {self.name!r} is closed")
        if self._n_of(key) > self.N_MAX:  # wider requests are never cached
            self.misses += 1
            return None
        out = np.empty(self.N_MAX, np.int32)
        got = self._lib.ycnr_cache_get(
            self._h, self._key(key), self.epoch,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if got < 0:
            self.misses += 1
            return None
        self.hits += 1
        return out[:got].copy()

    def put(self, key, value) -> bool:
        """True if stored; False when the entry is uncacheable
        (n > N_MAX — a truncated list would silently serve fewer items
        than the request asked for)."""
        if not self._h:
            raise ValueError(f"shm cache {self.name!r} is closed")
        if self._n_of(key) > self.N_MAX:
            return False
        items = np.ascontiguousarray(np.asarray(value, np.int32))
        self._lib.ycnr_cache_put(
            self._h, self._key(key), self.epoch,
            items.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(items))
        return True

    def put_if(self, key, value, cond) -> bool:
        # the shared cache is (key, epoch)-exact, so a stale put is
        # harmless (it can only be read by same-epoch readers); still
        # honor the caller's condition for interface parity. Propagate
        # put()'s stored/dropped verdict so precompute counts stay honest
        # (an n > N_MAX sweep would otherwise report a full cache).
        with self._lock:
            if not cond():
                return False
            return self.put(key, value)

    def invalidate(self, key=None):
        """key=None: bump the local epoch view — every existing entry
        misses for this process; fleet-wide invalidation happens when all
        processes adopt a new published epoch (set_epoch). key=user_id:
        overwrite that user's possible (user, n) slots with epoch-0
        tombstones (epoch 0 never matches a lookup — the >=1 contract),
        which IS fleet-wide: after a local online update, no process
        serves the user's stale list."""
        with self._lock:
            if key is None:
                self._bump += 1
                return
            user = key[0] if isinstance(key, tuple) else key
            dead = np.empty(0, np.int32)
            ptr = dead.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
            for n in range(self.N_MAX + 1):
                self._lib.ycnr_cache_put(self._h, self._key((user, n)), 0,
                                         ptr, 0)

    def invalidate_popular(self):
        """Tombstone every possible ("pop", 0, n, "count") slot — fleet-
        wide, like per-user invalidation (epoch-0 entries never match)."""
        if not self._h:
            raise ValueError(f"shm cache {self.name!r} is closed")
        dead = np.empty(0, np.int32)
        ptr = dead.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        with self._lock:
            for n in range(self.N_MAX + 1):
                self._lib.ycnr_cache_put(
                    self._h, self._key(("pop", 0, n, "count")), 0, ptr, 0)

    def stats(self) -> dict:
        out = (ctypes.c_int64 * 3)()
        self._lib.ycnr_cache_stats(self._h, out)
        return {"capacity": int(out[0]), "n_max": int(out[1]),
                "entries": int(out[2]), "hits": self.hits,
                "misses": self.misses}

    def close(self):
        if self._h:
            self._lib.ycnr_cache_detach(self._h)
            self._h = None

    def unlink(self):
        self._lib.ycnr_cache_unlink(self.name.encode())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

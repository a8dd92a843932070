"""In-process recommendation cache (counterpart of ``RecCache`` in
``ycnr_tpu/serve/cache.py``, whose package imports JAX).

Process-local LRU with optional TTL, internally locked so concurrent
serving threads can share one cache. The cross-process shm cache is not
ported yet.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Hashable, Optional


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

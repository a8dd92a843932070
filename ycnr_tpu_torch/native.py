"""Build and load the port's native host libraries (``csrc/<stem>.cc``).

The counterpart of ``ycnr_tpu/native/__init__.py``: the MovieLens parser
(``ingest``), the shared-memory factor store (``shm_store``) and the
cross-process recommendation cache (``shm_cache``). These are host code,
not CUDA. A library is compiled with ``g++`` at first use into
``ycnr_tpu_torch/_build/`` (listed in ``.gitignore``) under a name keyed by
a hash of the source and the build command. The compiler writes to a name
that holds the process id, and ``os.replace`` puts the finished file in
place, so processes that build at the same time never load a half-written
library. A host without ``g++`` gets ``None``; a ``g++`` that fails raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

_lock = threading.Lock()
_libs: dict = {}  # stem -> CDLL with its signatures set


def gxx_command(gxx: str, src: str, out: str) -> list[str]:
    """The one build command. No ``-march=native``: the build directory
    may be copied to a host with another CPU."""
    return [gxx, "-O3", "-std=c++17", "-shared", "-fPIC", src, "-o", out]


def source_path(stem: str) -> str:
    return os.path.join(CSRC, f"{stem}.cc")


def library_path(stem: str) -> str:
    h = hashlib.sha256(" ".join(gxx_command("g++", "", "")).encode())
    with open(source_path(stem), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libycnr_{stem}-{h.hexdigest()[:16]}.so")


def _build(stem: str) -> Optional[str]:
    """The library's path, compiled first when it is missing; ``None``
    without ``g++``."""
    out = library_path(stem)
    if os.path.exists(out):
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    res = subprocess.run(gxx_command(gxx, source_path(stem), tmp),
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed on {stem}.cc (rc {res.returncode}):"
                           f"\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def _load(stem: str, declare) -> Optional[ctypes.CDLL]:
    with _lock:
        if stem not in _libs:
            path = _build(stem)
            if path is None:
                return None
            _libs[stem] = declare(ctypes.CDLL(path))
        return _libs[stem]


def _declare_ingest(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    head = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int64,
            i32p, i32p, f32p]
    lib.ycnr_count_rows.restype = ctypes.c_longlong
    lib.ycnr_count_rows.argtypes = [ctypes.c_char_p]
    lib.ycnr_parse_ratings.restype = ctypes.c_longlong
    lib.ycnr_parse_ratings.argtypes = head
    lib.ycnr_parse_ratings_ts.restype = ctypes.c_longlong
    lib.ycnr_parse_ratings_ts.argtypes = head + [
        ctypes.POINTER(ctypes.c_int64)]
    lib.ycnr_pack_bits.restype = ctypes.c_int
    lib.ycnr_pack_bits.argtypes = [i32p, i32p, ctypes.c_int64,
                                   ctypes.c_int64,
                                   ctypes.POINTER(ctypes.c_uint32)]
    return lib


def _declare_shm(lib: ctypes.CDLL) -> ctypes.CDLL:
    fp = ctypes.POINTER(ctypes.c_float)
    lib.ycnr_shm_create.restype = ctypes.c_void_p
    lib.ycnr_shm_create.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                    ctypes.c_int64, ctypes.c_int64]
    lib.ycnr_shm_attach.restype = ctypes.c_void_p
    lib.ycnr_shm_attach.argtypes = [ctypes.c_char_p]
    lib.ycnr_shm_dims.restype = ctypes.c_int
    lib.ycnr_shm_dims.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int64)]
    lib.ycnr_shm_epoch.restype = ctypes.c_int64
    lib.ycnr_shm_epoch.argtypes = [ctypes.c_void_p]
    lib.ycnr_shm_publish.restype = ctypes.c_int
    lib.ycnr_shm_publish.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_double, fp, fp, fp, fp]
    lib.ycnr_shm_read.restype = ctypes.c_int64
    lib.ycnr_shm_read.argtypes = [ctypes.c_void_p, fp, fp, fp, fp,
                                  ctypes.POINTER(ctypes.c_double),
                                  ctypes.c_int]
    lib.ycnr_shm_detach.restype = ctypes.c_int
    lib.ycnr_shm_detach.argtypes = [ctypes.c_void_p]
    lib.ycnr_shm_unlink.restype = ctypes.c_int
    lib.ycnr_shm_unlink.argtypes = [ctypes.c_char_p]
    lib.ycnr_shm_busy_owner.restype = ctypes.c_uint32
    lib.ycnr_shm_busy_owner.argtypes = []
    return lib


def _declare_cache(lib: ctypes.CDLL) -> ctypes.CDLL:
    ip = ctypes.POINTER(ctypes.c_int32)
    lib.ycnr_cache_create.restype = ctypes.c_void_p
    lib.ycnr_cache_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                      ctypes.c_uint32]
    lib.ycnr_cache_attach.restype = ctypes.c_void_p
    lib.ycnr_cache_attach.argtypes = [ctypes.c_char_p]
    lib.ycnr_cache_put.restype = ctypes.c_int
    lib.ycnr_cache_put.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                   ctypes.c_int64, ip, ctypes.c_uint32]
    lib.ycnr_cache_get.restype = ctypes.c_int
    lib.ycnr_cache_get.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                   ctypes.c_int64, ip]
    lib.ycnr_cache_stats.restype = ctypes.c_int
    lib.ycnr_cache_stats.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int64)]
    lib.ycnr_cache_detach.restype = ctypes.c_int
    lib.ycnr_cache_detach.argtypes = [ctypes.c_void_p]
    lib.ycnr_cache_unlink.restype = ctypes.c_int
    lib.ycnr_cache_unlink.argtypes = [ctypes.c_char_p]
    return lib


def get_ingest_lib() -> Optional[ctypes.CDLL]:
    """The MovieLens parser and rated-bits packer (``csrc/ingest.cc``)."""
    return _load("ingest", _declare_ingest)


def get_shm_lib() -> Optional[ctypes.CDLL]:
    """The shared-memory factor store (``csrc/shm_store.cc``)."""
    return _load("shm_store", _declare_shm)


def get_cache_lib() -> Optional[ctypes.CDLL]:
    """The cross-process recommendation cache (``csrc/shm_cache.cc``)."""
    return _load("shm_cache", _declare_cache)

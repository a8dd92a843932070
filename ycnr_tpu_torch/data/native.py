"""Build and load the port's native MovieLens parser (``csrc/ingest.cc``).

Host code: a ctypes loader for the three parsing entry points and the
rated-bits packer, the port's counterpart of
``ycnr_tpu/native/__init__.py``'s parser half. The library
is compiled with ``g++`` at first use into ``ycnr_tpu_torch/_build/``
(listed in ``.gitignore``) under a name keyed by a hash of the source and
the build command. The compiler writes to a name that holds the process
id, and ``os.replace`` puts the finished file in place, so processes that
build at the same time never load a half-written library. A host without
``g++`` gets ``None`` and parses in Python (``data/movielens.py``); a
``g++`` that fails raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "ingest.cc")
BUILD_DIR = os.path.join(_PKG, "_build")


def gxx_command(gxx: str, src: str, out: str) -> list[str]:
    """The one build command. No ``-march=native``: the build directory
    may be copied to a host with another CPU."""
    return [gxx, "-O3", "-std=c++17", "-shared", "-fPIC", src, "-o", out]


def library_path() -> str:
    h = hashlib.sha256(" ".join(gxx_command("g++", "", "")).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libycnr_ingest-{h.hexdigest()[:16]}.so")


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
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


@functools.lru_cache(maxsize=None)
def load_library() -> Optional[ctypes.CDLL]:
    """The parser library with its signatures set, built first when the
    source changed; ``None`` on a host without ``g++``."""
    out = library_path()
    if not os.path.exists(out):
        gxx = shutil.which("g++")
        if gxx is None:
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        res = subprocess.run(gxx_command(gxx, SOURCE, tmp),
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"g++ failed (rc {res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    return _declare(ctypes.CDLL(out))


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def parse_ratings_native(path: str, sep: str, want_ts: bool = False):
    """Parse a ratings file natively: (u, i, r) int32 / int32 / float32 raw
    ids, plus the int64 timestamps (0 where the file has no 4th field)
    with ``want_ts``. ``None`` without the library, or when the parser
    found content but no row it could read (the caller then parses in
    Python, which is more tolerant)."""
    lib = load_library()
    if lib is None:
        return None
    n = lib.ycnr_count_rows(path.encode())
    if n < 0:
        raise FileNotFoundError(path)
    u = np.empty(n, np.int32)
    i = np.empty(n, np.int32)
    r = np.empty(n, np.float32)
    t = np.empty(n if want_ts else 0, np.int64)
    args = (path.encode(), sep.encode(), 1 if sep == "::" else 0, n,
            _ptr(u, ctypes.c_int32), _ptr(i, ctypes.c_int32),
            _ptr(r, ctypes.c_float))
    if want_ts:
        got = lib.ycnr_parse_ratings_ts(*args, _ptr(t, ctypes.c_int64))
    else:
        got = lib.ycnr_parse_ratings(*args)
    if got == -1:
        raise FileNotFoundError(path)
    if got == -2:
        return None
    out = (u[:got], i[:got], r[:got])
    return out + (t[:got],) if want_ts else out


def pack_bits_native(u, i, n_users: int, n_items: int):
    """Packed rated-set bitfield [n_users + 1, ceil(n_items / 32)] uint32
    through the native loop, or ``None`` without the library (the caller
    then packs with ``np.bitwise_or.at``: the same words, several times
    slower at 20M rows)."""
    lib = load_library()
    if lib is None:
        return None
    u = np.ascontiguousarray(u, np.int32)
    i = np.ascontiguousarray(i, np.int32)
    # the native loop checks no bounds: raise as the NumPy path would
    if len(u) and (int(u.min()) < 0 or int(u.max()) > int(n_users)
                   or int(i.min()) < 0 or int(i.max()) >= int(n_items)):
        raise IndexError(
            f"pack_bits: ids out of range (users 0..{n_users}, items "
            f"0..{int(n_items) - 1})")
    W = (int(n_items) + 31) // 32
    bits = np.zeros((int(n_users) + 1, W), np.uint32)
    lib.ycnr_pack_bits(_ptr(u, ctypes.c_int32), _ptr(i, ctypes.c_int32),
                       len(u), W, _ptr(bits, ctypes.c_uint32))
    return bits

"""The port's native MovieLens parser and rated-bits packer
(``csrc/ingest.cc``), the parser half of ``ycnr_tpu/native/__init__.py``.

The library is built and loaded by ``ycnr_tpu_torch/native.py``. A host
without ``g++`` gets ``None`` here and parses in Python
(``data/movielens.py``); a ``g++`` that fails raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ycnr_tpu_torch.native import get_ingest_lib


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def parse_ratings_native(path: str, sep: str, want_ts: bool = False):
    """Parse a ratings file natively: (u, i, r) int32 / int32 / float32 raw
    ids, plus the int64 timestamps (0 where the file has no 4th field)
    with ``want_ts``. ``None`` without the library, or when the parser
    found content but no row it could read (the caller then parses in
    Python, which is more tolerant)."""
    lib = get_ingest_lib()
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
    lib = get_ingest_lib()
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

"""Build and load the port's CUDA kernels (``ycnr_tpu_torch/csrc/*.cu``).

The kernels are compiled at first use with ``nvcc`` into one shared library
with a plain C interface and loaded with ``ctypes``; nothing here includes
PyTorch's headers, so a build takes seconds. The library lands in
``ycnr_tpu_torch/_build/`` (listed in ``.gitignore``) under a name keyed by a
hash of the sources and the build command, so an edited kernel is rebuilt
and an unchanged one is reused. Importing this module needs no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")


def sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith(".cu"))


def nvcc_command(nvcc: str, srcs: list[str], out: str) -> list[str]:
    """The one build command: Hopper ``sm_90a`` code, C++17, ``-O3``."""
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", out, *srcs]


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin or "
                           "/usr/local/cuda/bin): the CUDA kernels cannot "
                           "be built")
    return nvcc


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ycnr_spd_solve.argtypes = [p, p, p, i, i, p]
    lib.ycnr_spd_solve.restype = i
    lib.ycnr_fused_scores.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
    lib.ycnr_fused_scores.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (when the sources changed) and load the kernel library."""
    srcs = sources()
    nvcc = _find_nvcc()
    h = hashlib.sha256(" ".join(nvcc_command("nvcc", [], "")).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"libycnr_kernels-{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        res = subprocess.run(nvcc_command(nvcc, srcs, tmp),
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)
    return _declare(ctypes.CDLL(out))


def check(rc: int, what: str):
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")

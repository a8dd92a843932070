"""Build and load the port's CUDA kernels (``ycnr_tpu_torch/csrc/*.cu``).

The kernels are compiled at first use with ``nvcc``, one process per source
started together, and linked into one shared library with a plain C
interface and loaded with ``ctypes``; nothing here includes
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

import torch

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


def compile_command(nvcc: str, src: str, obj: str) -> list[str]:
    """``nvcc_command``'s flags for one source compiled to an object, so
    the sources compile in parallel before ``nvcc_command`` links them."""
    cmd = nvcc_command(nvcc, [src], obj)
    cmd[cmd.index("-shared")] = "-c"
    return cmd


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
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.ycnr_spd_solve.argtypes = [p, p, p, i, i, p]
    lib.ycnr_spd_solve.restype = i
    lib.ycnr_fused_scores.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                      p]
    lib.ycnr_fused_scores.restype = i
    lib.ycnr_row_gather.argtypes = [p, p, p, ll, ll, i, i, p]
    lib.ycnr_row_gather.restype = i
    lib.ycnr_take_along_rows.argtypes = [p, p, p, ll, i, i, ll, i, i, p]
    lib.ycnr_take_along_rows.restype = i
    lib.ycnr_fused_gram.argtypes = [p, p, p, p, p, p, ll, i, i, i, i, ll,
                                    i, p]
    lib.ycnr_fused_gram.restype = i
    lib.ycnr_fused_gram_weighted.argtypes = [p, p, p, p, p, ll, i, i, i, i,
                                             ll, i, p, p, f, f]
    lib.ycnr_fused_gram_weighted.restype = i
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
        objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
        procs = [subprocess.Popen(compile_command(nvcc, s, o),
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        res = [(p.returncode, log) for p, log in zip(procs, logs)]
        if all(rc == 0 for rc, _ in res):
            link = subprocess.run(nvcc_command(nvcc, objs, tmp),
                                  capture_output=True, text=True)
            res.append((link.returncode, link.stdout + link.stderr))
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
        bad = [f"rc {rc}:\n{log}" for rc, log in res if rc != 0]
        if bad:
            raise RuntimeError("nvcc failed:\n" + "\n".join(bad))
        os.replace(tmp, out)
    return _declare(ctypes.CDLL(out))


def stream(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device`` as the raw handle the C
    entry points take (without building a ``torch.cuda.Stream`` per
    launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(rc: int, what: str):
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")

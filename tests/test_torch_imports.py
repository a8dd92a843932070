"""The PyTorch/CUDA port's import boundary and kernel build command.

``ycnr_tpu_torch`` must import with JAX (and orbax) unavailable, and its
kernel modules must import without ``nvcc`` or ``triton``: kernels build
at first launch on a CUDA tensor, never at import.
"""

import glob
import os
import re
import subprocess
import sys
import textwrap

import torch

from ycnr_tpu_torch.ops import _build

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT = textwrap.dedent("""
    import importlib, pkgutil, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "orbax", "triton"):
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, Block())
    import ycnr_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        ycnr_tpu_torch.__path__, "ycnr_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "orbax", "triton")]
    assert not bad, bad
    print(len(names), "modules")
""")


def test_port_imports_without_jax_nvcc_or_triton():
    env = dict(os.environ, PATH="/nonexistent", PYTHONPATH=REPO,
               CUDA_HOME="/nonexistent")
    res = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[0]) >= 15  # every module of the slice


def test_build_command_targets_sm_90a():
    cmd = _build.nvcc_command("nvcc", ["a.cu", "b.cu"], "lib.so")
    assert cmd[:3] == ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a"]
    assert "-shared" in cmd and "-std=c++17" in cmd and "-O3" in cmd
    assert cmd[-3:] == ["lib.so", "a.cu", "b.cu"]


def test_kernel_sources_are_in_the_package():
    names = sorted(os.path.basename(s) for s in _build.sources())
    assert names == ["fused_topn.cu", "spd_solve.cu"]


def test_only_the_shared_module_imports_the_jax_package():
    """Every ycnr_tpu import of the port and of chip_smoke.py goes through
    ycnr_tpu_torch/shared.py (JAX-free host code, used as it is)."""
    pat = re.compile(r"^\s*(from|import)\s+ycnr_tpu(\.|\s|$)", re.M)
    files = glob.glob(os.path.join(REPO, "ycnr_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    offenders = []
    for f in files:
        with open(f) as fh:
            if pat.search(fh.read()) and not f.endswith("shared.py"):
                offenders.append(os.path.relpath(f, REPO))
    assert offenders == []


def test_chip_smoke_fails_without_a_gpu():
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout

"""The PyTorch/CUDA port's import boundary and kernel build command.

``ycnr_tpu_torch`` must import with JAX, orbax and the JAX package
(``ycnr_tpu``) unavailable, and its kernel modules must import without
``nvcc`` or ``triton``: kernels build at first launch on a CUDA tensor,
never at import.
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
            if name.split(".")[0] in ("jax", "jaxlib", "orbax", "triton",
                                      "ycnr_tpu"):
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, Block())
    import ycnr_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        ycnr_tpu_torch.__path__, "ycnr_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "orbax", "triton",
                                  "ycnr_tpu")]
    assert not bad, bad
    print(len(names), "modules")
    print(" ".join(names))
""")

# the modules each slice added, the probes included
_SLICE_MODULES = {
    "ycnr_tpu_torch.models.als", "ycnr_tpu_torch.models.ials",
    "ycnr_tpu_torch.ops.gram", "ycnr_tpu_torch.ops.row_gather",
    "ycnr_tpu_torch.ops.fused_gram", "ycnr_tpu_torch.serve.fold_in",
    "ycnr_tpu_torch.tools.probe_gather", "ycnr_tpu_torch.tools.bench_gather",
    "ycnr_tpu_torch.ops.spd_solve", "ycnr_tpu_torch.ops.fused_topn",
    "ycnr_tpu_torch.models.bucketed_phase", "ycnr_tpu_torch.train.loop",
    "ycnr_tpu_torch.config", "ycnr_tpu_torch.data.dataset",
    "ycnr_tpu_torch.data.movielens", "ycnr_tpu_torch.data.split",
    "ycnr_tpu_torch.data.synthetic", "ycnr_tpu_torch.ops.bucketed",
    "ycnr_tpu_torch.ops.layout", "ycnr_tpu_torch.data.native",
    "ycnr_tpu_torch.tools.bench_solve_score",
    "ycnr_tpu_torch.tools.bench_fused_gram",
    "ycnr_tpu_torch.oracle", "ycnr_tpu_torch.oracle.numpy_mf",
    "ycnr_tpu_torch.train.metrics", "ycnr_tpu_torch.train.checkpoint",
    "ycnr_tpu_torch.models.sgd", "ycnr_tpu_torch.models.sgd_stream",
    "ycnr_tpu_torch.models.bpr", "ycnr_tpu_torch.eval.recommend",
    "ycnr_tpu_torch.eval.ranking", "ycnr_tpu_torch.eval.similar",
    "ycnr_tpu_torch.serve.engine", "ycnr_tpu_torch.serve.cache",
    "ycnr_tpu_torch.cli", "ycnr_tpu_torch.__main__",
    "ycnr_tpu_torch.data.store", "ycnr_tpu_torch.utils",
    "ycnr_tpu_torch.utils.profiling", "ycnr_tpu_torch.train.tune",
    "ycnr_tpu_torch.native", "ycnr_tpu_torch.serve.shm",
    "ycnr_tpu_torch.serve.server", "ycnr_tpu_torch.examples",
    "ycnr_tpu_torch.examples.train_custom_data",
    "ycnr_tpu_torch.examples.serve_embedded",
    "ycnr_tpu_torch.examples.stream_sgd_and_serving",
    "ycnr_tpu_torch.examples.model_lifecycle",
    "ycnr_tpu_torch.examples.tune_and_similar",
    "ycnr_tpu_torch.examples.bpr_ranking",
    "ycnr_tpu_torch.ops.packed", "ycnr_tpu_torch.ops.sgd_wire",
    "ycnr_tpu_torch.models.ooc",
    "ycnr_tpu_torch.parallel", "ycnr_tpu_torch.parallel.mesh",
    "ycnr_tpu_torch.parallel.shard", "ycnr_tpu_torch.parallel.sgd_stream",
    "ycnr_tpu_torch.parallel.dual", "ycnr_tpu_torch.parallel.rank_main",
    "ycnr_tpu_torch.train.sharded", "ycnr_tpu_torch.examples.sharded_train",
    "ycnr_tpu_torch.parallel.ooc_mesh",
    "ycnr_tpu_torch.tools.bench", "ycnr_tpu_torch.tools.bench_ooc",
    "ycnr_tpu_torch.tools.bench_bpr_batch", "ycnr_tpu_torch.tools.soak",
    "ycnr_tpu_torch.tools.loadgen",
    "ycnr_tpu_torch.tools.quality_calibrated",
}


def test_port_imports_without_jax_nvcc_or_triton():
    """Every port module imports with jax, jaxlib, orbax, triton and the
    JAX package blocked, and without nvcc on the PATH."""
    env = dict(os.environ, PATH="/nonexistent", PYTHONPATH=REPO,
               CUDA_HOME="/nonexistent")
    res = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    count, names = res.stdout.splitlines()[:2]
    assert int(count.split()[0]) >= 65  # every module of the port
    assert _SLICE_MODULES <= set(names.split())


def test_build_command_targets_sm_90a():
    cmd = _build.nvcc_command("nvcc", ["a.cu", "b.cu"], "lib.so")
    assert cmd[:3] == ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a"]
    assert "-shared" in cmd and "-std=c++17" in cmd and "-O3" in cmd
    assert cmd[-3:] == ["lib.so", "a.cu", "b.cu"]


def test_compile_command_is_the_build_command_per_source():
    """Each source compiles alone (all started together) with the link
    command's flags, -c in place of -shared."""
    cmd = _build.compile_command("nvcc", "a.cu", "a.o")
    link = _build.nvcc_command("nvcc", ["a.cu"], "a.o")
    assert "-shared" not in cmd and "-c" in cmd
    assert [x for x in cmd if x != "-c"] == [x for x in link
                                             if x != "-shared"]


def test_kernel_sources_are_in_the_package():
    names = sorted(os.path.basename(s) for s in _build.sources())
    assert names == ["fused_gram.cu", "fused_topn.cu", "row_gather.cu",
                     "spd_solve.cu"]


def test_port_imports_nothing_of_the_jax_package():
    """No module of the port and not chip_smoke.py imports ycnr_tpu, nor the
    JAX package's root bench.py or its tools/: the port keeps its own
    copies of the host code it needs."""
    pat = re.compile(r"^\s*(from|import)\s+(ycnr_tpu|bench|tools)(\.|\s|$)",
                     re.M)
    files = glob.glob(os.path.join(REPO, "ycnr_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    offenders = []
    for f in files:
        with open(f) as fh:
            if pat.search(fh.read()):
                offenders.append(os.path.relpath(f, REPO))
    assert len(files) >= 66 and offenders == []


def test_chip_smoke_fails_without_a_gpu():
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


_BLOCKED_CLI = textwrap.dedent("""
    import runpy, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "orbax", "triton",
                                      "ycnr_tpu"):
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, Block())
    sys.argv = ["ycnr_tpu_torch"] + sys.argv[1:]
    runpy.run_module("ycnr_tpu_torch", run_name="__main__")
""")


def test_command_line_runs_with_the_jax_package_blocked(tmp_path):
    """python -m ycnr_tpu_torch prepare / presets, with jax and the JAX
    package unavailable."""
    env = dict(os.environ, PYTHONPATH=REPO)
    for argv in (["presets"],
                 ["prepare", "--source", "synthetic", "--store",
                  str(tmp_path / "s"), "--users", "30", "--items", "20",
                  "--ratings", "200"]):
        res = subprocess.run([sys.executable, "-c", _BLOCKED_CLI, *argv],
                             cwd=str(tmp_path), env=env, capture_output=True,
                             text=True, timeout=120)
        assert res.returncode == 0, res.stderr
    assert '"rows"' in res.stdout

"""Every example of the port (``ycnr_tpu_torch/examples``) runs on the CPU
with ``--device cpu`` and prints the marker that ``tests/test_examples.py``
looks for in the JAX package's script of the same name
(``sharded_train`` starts 8 gloo rank processes)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name,marker", [
    ("train_custom_data", "rmse per epoch"),
    ("serve_embedded", "cold user top-5"),
    ("stream_sgd_and_serving", "p99"),
    ("model_lifecycle", "served grown-catalog cohort OK"),
    ("tune_and_similar", "cache hits OK"),
    ("bpr_ranking", "pairwise lift"),
    ("sharded_train", "gathered factors"),
])
def test_example_runs(name, marker):
    p = subprocess.run(
        [sys.executable, "-m", f"ycnr_tpu_torch.examples.{name}", "--device",
         "cpu"], capture_output=True, text=True, timeout=420, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))
    assert p.returncode == 0, p.stderr[-2000:]
    assert marker in p.stdout, p.stdout

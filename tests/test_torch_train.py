"""Port's single-GPU train() (run here on the CPU) vs the JAX package's
train() on a tiny synthetic preset, both in float64."""

import dataclasses

import numpy as np
import pytest
import torch

from ycnr_tpu.config import ALSConfig, DataConfig, IALSConfig, RunConfig
from ycnr_tpu.data.dataset import load_dataset
from ycnr_tpu.train import checkpoint as jckpt
from ycnr_tpu.train.loop import train as jtrain
from ycnr_tpu_torch.train.loop import train as ttrain

torch.set_num_threads(1)

CFG = RunConfig(
    name="tiny", algorithm="als",
    data=DataConfig(n_users=200, n_items=120, n_ratings=4000, true_rank=4,
                    seed=0, max_groups=4),
    als=ALSConfig(rank=6, lam=0.05, epochs=3, dtype="float64"),
    ials=IALSConfig(rank=6, lam=0.1, alpha=2.0, epochs=3, dtype="float64"),
)


@pytest.mark.parametrize("algo", ["als", "ials"])
def test_train_rmse_history_matches_jax(tmp_path, algo):
    cfg = dataclasses.replace(CFG, algorithm=algo)
    ds = load_dataset(cfg.data, rank_hint=6)
    jr = jtrain(cfg, ds, out_dir=str(tmp_path / "j"))
    tr = ttrain(cfg, ds, out_dir=str(tmp_path / "t"), device="cpu")
    assert len(tr.rmse_history) == 3
    np.testing.assert_allclose(tr.rmse_history, jr.rmse_history, rtol=0,
                               atol=1e-9)
    # the port's final checkpoint loads in the JAX package
    st, man = jckpt.load_checkpoint(str(tmp_path / "t" / "ckpt"))
    assert man["epoch"] == 3
    np.testing.assert_allclose(np.asarray(st.U), np.asarray(jr.state.U),
                               rtol=1e-9, atol=1e-9)


def test_train_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError):
        ttrain(dataclasses.replace(CFG, algorithm="sgd"), device="cpu")

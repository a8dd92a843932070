"""ycnr_tpu_torch — the PyTorch/CUDA port of ycnr_tpu for one NVIDIA H100.

Mirrors the JAX package's module paths and function names: ALS-WR and iALS
on the bucketed layout with held-out RMSE, masked top-n serving, npz
checkpoints. Plain tensor code is PyTorch; the two TPU kernels on this path
are hand-written CUDA for Hopper (``csrc/``): K1, the batched SPD solve
(``ops/spd_solve.py``), and K2, the fused masked scorer
(``ops/fused_topn.py``). Imports torch, never JAX.
"""

import torch

__version__ = "0.1.0"


def full_precision_matmul():
    """Turn TF32 off for float32 products (matmul and cuDNN), as every
    entry point of the port does: the reference's numbers are f32's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


from ycnr_tpu_torch.models.base import (  # noqa: E402,F401
    MFState,
    init_state,
    rmse_padded,
    state_from_numpy,
    to_numpy,
)
from ycnr_tpu_torch.eval.recommend import (  # noqa: E402,F401
    recommend_all,
    recommend_users,
)
from ycnr_tpu_torch.serve.engine import Recommender  # noqa: E402,F401
from ycnr_tpu_torch.train.loop import TrainResult, train  # noqa: E402,F401

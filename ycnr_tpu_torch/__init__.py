"""ycnr_tpu_torch — the PyTorch/CUDA port of ycnr_tpu for one NVIDIA H100.

Mirrors the JAX package's module paths and function names: ALS-WR and iALS
on the bucketed and the blocked layouts, biased SGD (batched and stream)
and BPR, held-out RMSE and the ranking metrics, masked top-n serving with
online updates, fold-in, npz checkpoints. Plain tensor code is PyTorch; every TPU
kernel of the JAX package has a hand-written CUDA counterpart for Hopper
(``csrc/``): K1, the batched SPD solve (``ops/spd_solve.py``); K2, the fused
masked scorer (``ops/fused_topn.py``); the row gather (``ops/row_gather.py``)
and the fused gather -> Gram (``ops/fused_gram.py``). Imports torch, never
JAX.
"""

import torch

__version__ = "0.1.0"


def full_precision_matmul():
    """Turn TF32 off for float32 products (matmul and cuDNN), as every
    entry point of the port does: the reference's numbers are f32's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device, what: str):
    """The device an entry point runs on: ``device`` as given, and for
    None the card (``"cuda"``). Without a CUDA device, None raises; a CPU
    run passes ``device="cpu"``."""
    if device is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what}: no CUDA device; pass device='cpu' for "
                           f"a CPU run")
    return "cuda"


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

"""Checkpoint / resume, npz backend (counterpart of
``ycnr_tpu/train/checkpoint.py``).

Same files as the JAX package's npz backend — ``state-{epoch}.npz`` with
arrays U, V, bu, bi, mu (padded) and a format-3 ``manifest.json`` renamed
into place last as the one commit point — so checkpoints cross between the
two packages in both directions. The orbax backend is JAX-only.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Optional, Tuple

import numpy as np
import torch

from ycnr_tpu_torch import resolve_device
from ycnr_tpu_torch.models.base import MFState, state_from_numpy

_MANIFEST = "manifest.json"
_ARRAYS = "state.npz"


def _state_arrays(state: MFState) -> dict:
    out = {}
    for name, x in zip(MFState._fields, state):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            # NumPy has no bfloat16: store widened to float32; the loader
            # casts back to the manifest's dtype (lossless)
            x = x.float()
        out[name] = x.numpy()
    return out


def _gc_stale_arrays(path: str, keep: str):
    """Drop array files of superseded epochs AFTER the manifest commit."""
    for entry in os.listdir(path):
        if entry == keep or not entry.startswith("state-"):
            continue
        full = os.path.join(path, entry)
        try:
            if os.path.isdir(full):
                shutil.rmtree(full)
            else:
                os.remove(full)
        except OSError:
            pass  # concurrent reader/cleaner; stale files are harmless


def save_checkpoint(path: str, state: MFState, epoch: int,
                    config: Optional[dict] = None,
                    extra: Optional[dict] = None):
    """Snapshot state into directory ``path`` (atomic: the manifest naming
    the arrays is renamed into place last)."""
    os.makedirs(path, exist_ok=True)
    arrays = f"state-{epoch}.npz"
    tmp = os.path.join(path, arrays + ".tmp.npz")
    np.savez(tmp, **_state_arrays(state))
    os.replace(tmp, os.path.join(path, arrays))
    manifest = {
        "epoch": int(epoch),
        "rank": int(state.U.shape[1]),
        "n_users": int(state.U.shape[0] - 1),
        "n_items": int(state.V.shape[0] - 1),
        "dtype": str(state.U.dtype).removeprefix("torch."),
        "config": config or {},
        "extra": extra or {},
        "backend": "npz",
        "arrays": arrays,
        "format": 3,
    }
    mtmp = os.path.join(path, _MANIFEST + ".tmp")
    with open(mtmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(mtmp, os.path.join(path, _MANIFEST))
    _gc_stale_arrays(path, arrays)


def load_checkpoint(path: str, device=None) -> Tuple[MFState, dict]:
    """Restore (state, manifest) from an npz-backend checkpoint directory
    written by either package, onto ``device`` (None: the card)."""
    device = resolve_device(device, "load_checkpoint()")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("backend", "npz") != "npz":
        raise ValueError(f"{path}: backend {manifest['backend']!r} is "
                         "JAX-only; the port reads npz checkpoints")
    dtype = getattr(torch, manifest.get("dtype", "float32"))
    with np.load(os.path.join(path, manifest.get("arrays", _ARRAYS))) as z:
        state = state_from_numpy(z["U"], z["V"], z["bu"], z["bi"], z["mu"],
                                 device=device, dtype=dtype)
    return state, manifest


def config_dict(cfg) -> dict:
    """The run config as the plain dict a manifest carries."""
    return dataclasses.asdict(cfg)

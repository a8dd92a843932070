"""Typed configuration system: the port's own copy of ``ycnr_tpu/config.py``.

Frozen dataclasses with one preset per BASELINE.json config (lines 6-12).
The copy is field for field the JAX package's, so ``asdict`` of either
gives the same dict and a checkpoint manifest's ``config`` reads the same
from both packages (``tests/test_torch_host_copies.py`` holds that). Some
fields name options only the JAX package implements (sharding,
out-of-core, shm publishing, orbax); the port's ``train`` refuses them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class DataConfig:
    """Dataset selection & layout parameters (reference C7 ingestion config)."""

    source: str = "synthetic"  # synthetic | ml-100k | ml-1m | ml-20m | path
    path: Optional[str] = None  # file path for movielens sources
    n_users: int = 1000  # synthetic only
    n_items: int = 500  # synthetic only
    n_ratings: int = 50_000  # synthetic only
    true_rank: int = 8  # synthetic planted rank
    noise: float = 0.25  # synthetic rating noise sigma
    # "planted" = base generator; "calibrated" = quantile-mapped to the
    # published ML-20M rating histogram + Pareto user degrees with the
    # >=20 floor (data/synthetic.synthetic_ratings_calibrated)
    synthetic_mode: str = "planted"
    seed: int = 0
    test_fraction: float = 0.1  # held-out split (reference train/test split)
    # split protocol: "random" holdout, "time" (temporal global holdout by
    # the stored timestamp column), or "last-out" (per-user leave-last-k
    # most recent; the classic top-N protocol) — data/split.py
    split: str = "random"
    last_k: int = 1  # k for split="last-out"
    chunk_len: int = 32  # L: ratings per chunk in the blocked-CSR layout
    # bucket-group cap for the single-device bucketed layout: fewer groups
    # cost some padding fill (ops/bucketed.py)
    max_groups: int = 16
    block_chunks: Optional[int] = None  # C_B: chunks per block (None = auto)


@dataclass(frozen=True)
class ALSConfig:
    """ALS-WR hyperparameters (Zhou et al.; SURVEY.md C9 / Appendix A)."""

    rank: int = 10
    lam: float = 0.05  # weighted-lambda: per-entity lambda * n_e
    epochs: int = 10
    dtype: str = "float32"
    # "bfloat16" halves gather bandwidth (f32 Gram accumulation kept);
    # ~1e-3 class accuracy cost - see models/bucketed_phase.py
    gather_dtype: str = "float32"


@dataclass(frozen=True)
class SGDConfig:
    """Biased SGD-MF hyperparameters (Funk/Koren; SURVEY.md C10)."""

    rank: int = 10
    lam: float = 0.02
    lr: float = 0.01
    lr_decay: float = 0.95  # per-epoch multiplicative decay
    epochs: int = 20
    batch_size: int = 4096
    init_scale: float = 0.1
    dtype: str = "float32"
    # "sum" = per-sample accumulation (oracle-exact); "mean" = per-entity
    # batch-mean, stable for hot entities in large batches (see models/sgd.py)
    grad_mode: str = "sum"
    # "batched" = uniformly-shuffled batches (models/sgd.py, the oracle
    # semantics); "stream" = user-sorted pass-striped stream with
    # batch-order reshuffle (models/sgd_stream.py) — scatter-free access
    # pattern; the default grad_mode "sum" maps to
    # "capped" there (min(multiplicity, cap) effective step — matches the
    # batched-sum trajectory without hot-entity divergence); "mean"
    # passes through unchanged
    method: str = "batched"


@dataclass(frozen=True)
class IALSConfig:
    """Implicit weighted ALS (Hu/Koren/Volinsky; SURVEY.md C11)."""

    rank: int = 10
    lam: float = 0.1
    alpha: float = 40.0  # confidence c = 1 + alpha * r
    epochs: int = 10
    dtype: str = "float32"
    gather_dtype: str = "float32"


@dataclass(frozen=True)
class BPRConfig:
    """BPR-MF pairwise ranking (Rendle 2009; models/bpr.py).

    Beyond-parity: the reference has no ranking trainer. Deterministic
    mini-batched updates over (user, pos-item, sampled-neg-item) triples;
    one uniform negative per observed pair per epoch, collisions with the
    rated set zero-weighted via the packed rated-bits table."""

    rank: int = 32
    lam: float = 0.01
    lr: float = 0.05
    lr_decay: float = 0.98
    epochs: int = 30
    batch_size: int = 8192
    dtype: str = "float32"
    # "sum" = per-sample accumulation (oracle-exact; hot entities can
    # overstep at large batches); "mean" divides each entity's update by
    # its realized batch multiplicity (stable, at the cost of on-device
    # counts); "emean" (default) divides by the EXPECTED multiplicity —
    # deterministic weights precomputed from the training degrees ride
    # along as fused factor columns (models/bpr.py)
    grad_mode: str = "emean"
    # "batches" (default) fixes batch COMPOSITION at prepare time (one
    # host shuffle) and reshuffles only the batch ORDER per epoch —
    # negatives stay fresh, so the quality trajectory matches "rows"
    # while skipping the per-epoch full-row device permutation
    # (models/bpr.bpr_epoch_batches).
    # "rows" = full per-epoch row shuffle (the oracle-parity mode)
    shuffle: str = "batches"


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh / parallelism config.

    Replaces the reference worker-count + fork/IPC settings (SURVEY.md C2-C4):
    ``n_shards`` plays the role of the worker count; the epoch barrier and the
    shared factor view are expressed as shardings + collectives (SURVEY.md §2
    parallelism table P1-P4).
    """

    n_shards: int = 1  # 1 = single chip, no mesh
    # mesh axis name. Fixed: every shard_map spec / psum in parallel/ binds
    # the module constant AXIS='shard'; any other value would fail at the
    # first collective, so reject it at config time instead.
    axis: str = "shard"

    def __post_init__(self):
        if self.axis != "shard":
            raise ValueError(
                "MeshConfig.axis must be 'shard' (parallel/shard.py and "
                "parallel/dual.py bind that axis name in every collective)")
    # V-step strategy when sharded (SURVEY.md M6):
    #   "gram_psum": ratings stay user-sharded; per-item Gram matrices are
    #                psum'd over ICI (the BASELINE.json:5 prescribed collective)
    #   "item_sharded": re-bucket by item across the mesh; no Gram psum
    vstep_mode: str = "gram_psum"


@dataclass(frozen=True)
class RunConfig:
    name: str = "run"
    algorithm: str = "als"  # als | sgd | ials | bpr
    data: DataConfig = field(default_factory=DataConfig)
    als: ALSConfig = field(default_factory=ALSConfig)
    sgd: SGDConfig = field(default_factory=SGDConfig)
    ials: IALSConfig = field(default_factory=IALSConfig)
    bpr: BPRConfig = field(default_factory=BPRConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    topn: int = 10
    seed: int = 0
    out_dir: str = "runs"
    checkpoint_every: int = 1  # epochs between checkpoints (0 = off)
    checkpoint_backend: str = "npz"  # npz | orbax (train/checkpoint.py)
    # stop when held-out RMSE has not improved by min_delta for `patience`
    # consecutive epochs (0 = run all epochs, the reference behavior)
    early_stop_patience: int = 0
    early_stop_min_delta: float = 0.0
    log_train_rmse: bool = True  # per-epoch train RMSE in metrics
    # also log hit@topn per epoch and the final ranking suite for the
    # EXPLICIT trainers (als/sgd) — implicit models (ials/bpr) always do.
    # Lets the quality comparison (tools/quality_calibrated.py) rank all
    # four trainers on one shared split with identical eval machinery.
    log_hit_rate: bool = False
    # >1 fuses that many epochs (plus their RMSE evals) into one device
    # program in the JAX package (models/bucketed_phase.als_epochs_bucketed);
    # the port runs eagerly, so nothing is fused, but it keeps the block
    # boundaries: single-GPU ALS/iALS log each record with fused=k, take the
    # iALS hit rate, early-stop and checkpoint only at a block's end
    fused_epochs: int = 1
    # out-of-core training (models/ooc.py): keep only the factors (and as
    # much of the compressed wire as fits) resident and stream the rest
    # host->HBM through every epoch (ops/packed.py) — bounds trainable
    # nnz by host RAM/disk instead of device memory (the reference's
    # portioned DB streaming, SURVEY.md L1->L5). Single-chip ALS/iALS
    # only; streamed groups are wire-bandwidth-bound, HBM-pinned groups
    # run at near-resident speed (docs/KERNELS.md "Out-of-core
    # streaming").
    ooc: bool = False
    # OOC wire format: "packed" (minimal bytes — the default: both the
    # host wire and the HBM-pinned footprint are byte-bound) or "rect"
    # (padded rectangles, gather-free device decode — for hosts with a
    # fast local link where the decode, not the wire, binds)
    ooc_wire: str = "packed"
    # OOC wire residency: "auto" pins whole wire groups in HBM under
    # auto_wire_budget (largest first) and streams the remainder;
    # "host" forces pure streaming (the pre-round-4 behavior); "device"
    # pins everything (fails on HBM exhaustion rather than falling back)
    ooc_residency: str = "auto"
    measure_serving: bool = False  # time top-N for all users after training
    # serving scorer for measure_serving / offline top-N: exact | fused |
    # fused32 (fused = Pallas kernel, ops/pallas_topn.py; falls back to
    # exact when the catalog is too small for the two-level select)
    scorer: str = "exact"
    # shm segment name to publish factors into after each checkpointed epoch
    # (serving processes attach via serve.ShmRecommender) — reference C6c
    publish_shm: Optional[str] = None

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Presets: one per BASELINE.json "configs" entry (lines 6-12).
# ---------------------------------------------------------------------------

_PRESETS = {
    # BASELINE.json:7 — "ALS-WR factorization of MovieLens-100K, rank 10,
    # explicit ratings"
    "ml100k-als": RunConfig(
        name="ml100k-als",
        algorithm="als",
        data=DataConfig(source="ml-100k", n_users=943, n_items=1682,
                        n_ratings=100_000, chunk_len=32),
        als=ALSConfig(rank=10, lam=0.05, epochs=10),
    ),
    # BASELINE.json:8 — "SGD factorization with user/item bias terms
    # (MovieLens-1M)"
    "ml1m-sgd": RunConfig(
        name="ml1m-sgd",
        algorithm="sgd",
        data=DataConfig(source="ml-1m", n_users=6040, n_items=3706,
                        n_ratings=1_000_209, chunk_len=32),
        sgd=SGDConfig(rank=16, lam=0.02, lr=0.005, epochs=20,
                      batch_size=8192),
    ),
    # BASELINE.json:9 — "ALS-WR rank 64 on MovieLens-20M with held-out RMSE"
    "ml20m-als": RunConfig(
        name="ml20m-als",
        algorithm="als",
        data=DataConfig(source="ml-20m", n_users=138_493, n_items=26_744,
                        n_ratings=20_000_263, chunk_len=32),
        als=ALSConfig(rank=64, lam=0.05, epochs=10,
                      gather_dtype="bfloat16"),
    ),
    # BASELINE.json:10 — "Implicit-feedback weighted ALS (confidence-weighted,
    # binarized ML-20M)"
    "ml20m-ials": RunConfig(
        name="ml20m-ials",
        algorithm="ials",
        # iALS binarizes preferences internally (p = 1 on observed pairs)
        # and uses the raw rating as confidence c = 1 + alpha*r (Hu/Koren)
        data=DataConfig(source="ml-20m", n_users=138_493, n_items=26_744,
                        n_ratings=20_000_263, chunk_len=32),
        ials=IALSConfig(rank=64, lam=0.1, alpha=40.0, epochs=10,
                        gather_dtype="bfloat16"),
    ),
    # Beyond parity: pairwise ranking on binarized ML-20M (the implicit
    # config's shape), models/bpr.py
    "ml20m-bpr": RunConfig(
        name="ml20m-bpr",
        algorithm="bpr",
        data=DataConfig(source="ml-20m", n_users=138_493, n_items=26_744,
                        n_ratings=20_000_263, chunk_len=32),
        bpr=BPRConfig(rank=32, lam=0.01, lr=0.05, epochs=30,
                      batch_size=65_536),
    ),
    # BASELINE.json:11 — "Sharded ALS + full top-N recommendation serving over
    # 8-chip mesh (Netflix-scale synthetic)"
    "netflix-sharded": RunConfig(
        name="netflix-sharded",
        algorithm="als",
        data=DataConfig(source="synthetic", n_users=480_189, n_items=17_770,
                        n_ratings=100_480_507, true_rank=32, chunk_len=32),
        als=ALSConfig(rank=64, lam=0.05, epochs=5,
                      gather_dtype="bfloat16"),
        mesh=MeshConfig(n_shards=8),
        topn=10,
    ),
}


def config_from_dict(d: dict, base: Optional[RunConfig] = None) -> RunConfig:
    """Build a RunConfig from a (possibly partial) nested dict — the
    file-based config entry (reference C14: a config module consumed at
    startup). ``{"preset": name}`` selects the base; nested keys ("data",
    "als", "sgd", "ials", "bpr", "mesh") replace fields of the sub-configs;
    top-level keys replace RunConfig fields. Unknown keys raise."""
    cfg = base if base is not None else (
        get_preset(d["preset"]) if "preset" in d else RunConfig())
    sub = {"data": DataConfig, "als": ALSConfig, "sgd": SGDConfig,
           "ials": IALSConfig, "bpr": BPRConfig, "mesh": MeshConfig}
    top = {f.name for f in dataclasses.fields(RunConfig)}
    kw = {}
    for k, v in d.items():
        if k == "preset":
            continue
        if k in sub:
            kw[k] = dataclasses.replace(getattr(cfg, k), **v)
        elif k in top:
            kw[k] = v
        else:
            raise KeyError(f"unknown config key {k!r}")
    return cfg.replace(**kw)


def load_config(path: str, base: Optional[RunConfig] = None) -> RunConfig:
    """Load a JSON config file via config_from_dict."""
    import json

    with open(path) as f:
        return config_from_dict(json.load(f), base)


def get_preset(name: str) -> RunConfig:
    if name not in _PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(_PRESETS)}")
    return _PRESETS[name]


def list_presets() -> list[str]:
    return sorted(_PRESETS)

"""Sharded training and serving on ``torch.distributed`` (counterpart of
``ycnr_tpu/parallel``): the mesh and its launchers (``mesh.py``), the
user-sharded epochs with the item-Gram all-reduce (``shard.py``), sharded
stream SGD (``sgd_stream.py``), the item-sharded V-step (``dual.py``) and
out of core on the mesh (``ooc_mesh.py``)."""

from ycnr_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    init_distributed,
    make_mesh,
    run_ranks,
    spawn_ranks,
)
from ycnr_tpu_torch.parallel.ooc_mesh import (  # noqa: F401
    ShardedWire,
    build_sharded_wire,
    feed_sharded_wire,
    make_sharded_ooc_epoch,
    put_sharded_wire,
)
from ycnr_tpu_torch.parallel.shard import (  # noqa: F401
    ShardedData,
    ShardedState,
    build_bpr_bits,
    build_sharded_data,
    gather_state,
    put_shard,
    scatter_state,
    sharded_als_epoch,
    sharded_bpr_epoch,
    sharded_ials_epoch,
    sharded_recommend_all,
    sharded_rmse,
    sharded_sgd_epoch,
)

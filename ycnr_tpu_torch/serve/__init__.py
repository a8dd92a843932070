from ycnr_tpu_torch.serve.cache import RecCache  # noqa: F401
from ycnr_tpu_torch.serve.engine import Recommender  # noqa: F401
from ycnr_tpu_torch.serve.fold_in import (  # noqa: F401
    fold_in_items,
    fold_in_users,
    recommend_fold_in,
)
from ycnr_tpu_torch.serve.shm import (  # noqa: F401
    FactorShmReader,
    FactorShmWriter,
    ShmRecommender,
    publish_checkpoint,
    shm_available,
)

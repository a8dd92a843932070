"""The host-side ``ycnr_tpu`` code the port uses as it is.

These modules hold NumPy only, and so do their packages' ``__init__``
files, so they import on a machine without JAX: the synthetic generator,
the train/test split, the dataset loader, the config dataclasses and the
layouts (``build_bucketed``, ``build_blocked_csr``, ``pad_coo``). Every
import of ``ycnr_tpu`` in the port goes through this module. Host code
that lives in a package importing JAX (``eval.recommend.build_rated_bits``,
``serve.cache.RecCache``) is copied into the port instead.
"""

from ycnr_tpu.config import RunConfig  # noqa: F401
from ycnr_tpu.data.dataset import Dataset, load_dataset  # noqa: F401
from ycnr_tpu.data.split import train_test_split  # noqa: F401
from ycnr_tpu.data.synthetic import synthetic_ratings  # noqa: F401
from ycnr_tpu.ops.bucketed import (  # noqa: F401
    BucketedCSR,
    BucketGroup,
    build_bucketed,
)
from ycnr_tpu.ops.layout import (  # noqa: F401
    BlockedCSR,
    build_blocked_csr,
    pad_coo,
)

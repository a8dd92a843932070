"""Host-side data: synthetic ratings, MovieLens files, splits, datasets.

NumPy only; the port's own copy of ``ycnr_tpu/data``, the ratings store
(``store.RatingsStore``) included.
"""

from ycnr_tpu_torch.data.synthetic import synthetic_ratings  # noqa: F401
from ycnr_tpu_torch.data.split import train_test_split  # noqa: F401
from ycnr_tpu_torch.data.movielens import load_movielens  # noqa: F401
from ycnr_tpu_torch.data.dataset import Dataset, load_dataset  # noqa: F401

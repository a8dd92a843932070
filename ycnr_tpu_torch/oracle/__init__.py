from ycnr_tpu_torch.oracle.numpy_mf import (  # noqa: F401
    als_wr_epoch,
    bpr_epoch_batched,
    ials_epoch,
    predict,
    rmse,
    sgd_epoch_batched,
    topn,
)

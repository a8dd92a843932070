from ycnr_tpu_torch.models.base import (  # noqa: F401
    MFState,
    device_layout,
    init_state,
)
from ycnr_tpu_torch.models.als import ALSWR  # noqa: F401
from ycnr_tpu_torch.models.ials import ImplicitALS  # noqa: F401

"""Tracing and profiling hooks (counterpart of ``ycnr_tpu/utils``)."""

from ycnr_tpu_torch.utils.profiling import phase_timer, trace  # noqa: F401

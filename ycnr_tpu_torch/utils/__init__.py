"""Tracing and profiling hooks (counterpart of ``ycnr_tpu/utils``)."""

from ycnr_tpu_torch.utils.profiling import span, trace  # noqa: F401

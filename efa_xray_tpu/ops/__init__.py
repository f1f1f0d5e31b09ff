"""Triton kernels for the EnSRF phases and the one place that selects
them (:mod:`efa_xray_tpu.ops.select`)."""

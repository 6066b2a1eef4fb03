"""Differential privacy — counterpart of ``fedml_tpu/core/dp``."""

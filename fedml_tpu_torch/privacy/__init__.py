"""Privacy layers of the port — counterpart of ``fedml_tpu/privacy``."""

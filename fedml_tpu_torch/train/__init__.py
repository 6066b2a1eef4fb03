"""Training — counterparts of ``fedml_tpu/train``."""

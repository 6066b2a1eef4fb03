"""Federated datasets — numpy counterparts of ``fedml_tpu/data``."""

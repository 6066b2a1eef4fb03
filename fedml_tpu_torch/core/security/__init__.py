"""Attacks and defenses — counterpart of ``fedml_tpu/core/security``."""

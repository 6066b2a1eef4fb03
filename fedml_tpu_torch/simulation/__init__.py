"""Simulation helpers — counterparts of ``fedml_tpu/simulation``."""

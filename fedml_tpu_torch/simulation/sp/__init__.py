"""The single-process simulation engine."""

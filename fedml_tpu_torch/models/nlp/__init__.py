"""Sequence models of the port."""

"""Data partitioning — numpy, as in the reference."""

"""Server aggregators."""

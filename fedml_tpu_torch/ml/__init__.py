"""Machine-learning operators of the port: local trainers and aggregators."""

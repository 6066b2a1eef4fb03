"""The algorithm framework: client trainer and server aggregator bases."""

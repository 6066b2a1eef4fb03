"""Llama family of the port: model and weight conversion."""

"""Core framework pieces of the port."""

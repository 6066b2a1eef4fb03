"""Vision models of the port."""

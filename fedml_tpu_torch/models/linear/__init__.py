"""Linear models of the port."""

"""Client trainers."""

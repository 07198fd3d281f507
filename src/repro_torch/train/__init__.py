"""Training and serving loops of the port."""

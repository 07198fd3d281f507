"""Hand-written Hopper kernels of the port, one package per kernel."""

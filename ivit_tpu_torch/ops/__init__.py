"""Integer cores and the Hopper kernels of the port."""

"""Hopper kernels of the port."""

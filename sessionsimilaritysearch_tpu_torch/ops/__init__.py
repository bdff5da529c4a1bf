"""Kernels of the port (CUDA C++ under ``csrc/``) and the torch ops around them."""

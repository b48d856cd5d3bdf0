"""Kernels of the port: CUDA C++ sources in ``csrc/``, their ctypes
wrappers, and the plain PyTorch version beside each."""

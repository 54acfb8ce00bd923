"""Kernels of the port: hand-written CUDA under csrc/, each with its plain version."""

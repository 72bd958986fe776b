"""Tensor primitives and the wrappers of the CUDA kernels (csrc/)."""

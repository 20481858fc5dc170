"""Segment reductions, measurement kernels and their CUDA forms."""

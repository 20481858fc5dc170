"""Segment reductions, measurement kernels, the pixel-stage kernels and their CUDA forms."""

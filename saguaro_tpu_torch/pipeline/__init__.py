"""Segmentation, measurement, the feature-extraction job and the pixel stages."""

"""Segmentation, measurement and the feature-extraction job."""

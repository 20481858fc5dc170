"""Segmentation network and weight bridge."""

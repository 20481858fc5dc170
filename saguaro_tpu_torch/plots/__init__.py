"""Plots of the hit-calling stage."""

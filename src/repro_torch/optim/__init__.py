"""Optimizer-side features of the port: sketch-based gradient compression."""

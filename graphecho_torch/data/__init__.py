"""Synthetic data for the port (numpy; NHWC batch dicts)."""

"""Synthetic data with input-size dynamics."""

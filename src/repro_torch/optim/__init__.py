"""Optimizers written out to match the reference."""

"""The bucketed training loop."""

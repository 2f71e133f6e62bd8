"""The dense language model and its layers."""

"""Model configurations the port runs (one module per architecture)."""

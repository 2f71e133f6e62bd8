"""Plain references, one module per block family, found by the name a
configuration file gives under ``"reference"``."""

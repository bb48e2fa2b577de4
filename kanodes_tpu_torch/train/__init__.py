"""Training loop and config overrides."""

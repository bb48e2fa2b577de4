"""KAN layers and containers."""

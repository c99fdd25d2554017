"""Custom-gradient ops of the hot path, in plain JAX."""

"""File IO shared with the JAX package (numpy only)."""

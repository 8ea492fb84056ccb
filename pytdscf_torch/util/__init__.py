"""Host-side utilities of the port (copies of the JAX package's)."""

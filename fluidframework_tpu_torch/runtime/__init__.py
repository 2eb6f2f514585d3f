"""Copies of the JAX package's runtime modules the port needs (the op
attributor, for attribution documents that fall back to the oracle)."""

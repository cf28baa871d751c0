"""Configuration and performance monitoring (jax-free copies)."""

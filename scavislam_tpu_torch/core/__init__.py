"""Core math: Lie groups and camera models (PyTorch)."""

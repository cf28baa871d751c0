"""Synthetic stereo sequences rendered with PyTorch."""

"""Device ops: image pyramid, block-matching stereo (plain PyTorch twin and
the hand-written CUDA kernel), FAST corners, patch geometry."""

"""scavislam_tpu_torch — the PyTorch + CUDA port of scavislam_tpu.

The JAX package ``scavislam_tpu`` is the reference: every module here mirrors
its twin's layout and public names (``core/ ops/ models/ io/ utils/``) and is
held against it by the ``tests/test_torch_*.py`` parity tests. This package
never imports jax or scavislam_tpu.

Ported so far: the stereo visual-odometry slice (``models.frontend.
StereoFrontend`` on its synchronous path) with the block matcher written by
hand in CUDA C++ for Hopper (``ops/stereo_bm.py`` + ``csrc/stereo_bm.cu``).

Device policy: every function runs on the device of the tensors it is given;
objects that hold state (``StereoFrontend``, ``SyntheticSequence``) take an
explicit ``device`` argument. There is no hidden global device.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry is exact f32 everywhere, mirroring the JAX package's
# jax_default_matmul_precision="highest": no TF32 in matmuls or convolutions.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

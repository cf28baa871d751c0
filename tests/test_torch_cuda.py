"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions. Every test here needs a CUDA card and skips without one.

This file imports no JAX (the machine with the card has none), so on a card:

    python -m pytest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.io.synthetic import SyntheticSequence
from scavislam_tpu_torch.ops import stereo_bm
from scavislam_tpu_torch.ops.image import binomial3
from scavislam_tpu_torch.ops.stereo import _sobel_x_prefilter

# the 256x192 stereo-test camera (tests/test_ops_stereo.py)
CAM = StereoCamera.create(195.0, (127.0, 95.0), (256, 192), 0.35)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stereo_bm kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture
def pair(cuda_device):
    f = SyntheticSequence(CAM, n_frames=1, device=cuda_device).frame(0)
    return f["left"], f["right"]


@pytest.mark.cuda
@pytest.mark.parametrize("num_disp", [32, 64])
def test_kernel_matches_plain_on_card(pair, num_disp):
    # same summation order and --fmad=false: bit-for-bit
    left, right = pair
    lf = _sobel_x_prefilter(binomial3(left))
    rf = _sobel_x_prefilter(binomial3(right))
    dk = stereo_bm.bm_cuda(lf, rf, num_disp=num_disp, radius=5)
    dp = stereo_bm.bm_plain(lf, rf, num_disp=num_disp, radius=5)
    torch.cuda.synchronize()
    assert (dk > 0).float().mean() > 0.3
    assert torch.equal(dk, dp)


@pytest.mark.cuda
def test_kernel_counts_launches_and_any_height(pair):
    # H = 190 is no multiple of 32 (the TPU kernel's slab height); the
    # counted wrapper launches once and agrees with the CPU plain version
    left, right = pair
    l, r = left[:190], right[:190]
    before = stereo_bm.block_matching_disparity_bm.launches
    dk = stereo_bm.block_matching_disparity_bm(l, r, num_disp=64)
    assert stereo_bm.block_matching_disparity_bm.launches == before + 1
    dp = stereo_bm.block_matching_disparity_bm(l.cpu(), r.cpu(), num_disp=64)
    assert torch.equal(dk.cpu(), dp)

"""The block-matching kernel module (scavislam_tpu_torch.ops.stereo_bm).

On the CPU the plain PyTorch version is held against the Pallas TPU kernel
it replaces, run in interpret mode at the production 64 disparities, and
against ground truth. The CUDA kernel itself only runs on a card:
``tests/test_torch_cuda.py`` holds it against the plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scavislam_tpu.core.camera import StereoCamera as JCam
from scavislam_tpu.io.synthetic import SyntheticSequence
from scavislam_tpu.ops.stereo_pallas import block_matching_disparity_pallas
from scavislam_tpu_torch.ops import stereo_bm
from scavislam_tpu_torch.ops.stereo import _sobel_x_prefilter

# the 256x192 stereo-test camera (tests/test_ops_stereo.py)
CAM = JCam.create(195.0, (127.0, 95.0), (256, 192), 0.35)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the port issues thousands of small eager ops per
    frame, and with a test process per core torch's default of a thread per
    core in every process oversubscribes the machine (measured ~17x slower
    for two of these files in two processes on 8 cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    f = SyntheticSequence(CAM, n_frames=1).frame(0)
    return (np.array(f["left"]), np.array(f["right"]), np.array(f["disp_gt"]))


@pytest.fixture(scope="module")
def plain_disp(pair):
    left, right, _ = pair
    return stereo_bm.block_matching_disparity_bm(
        torch.as_tensor(left), torch.as_tensor(right), num_disp=64,
        radius=5).numpy()


def test_plain_matches_pallas_kernel(pair, plain_disp):
    # Same BIG-constant semantics. The Pallas kernel sums the 11 window rows
    # as a banded matmul, the port row by row, so the f32 costs differ in the
    # last bit and a near-tie could take the other argmin. Measured at
    # 256x192, D=64: valid masks agree on 100% of pixels and |Δ| <= 1e-3 px
    # on 100% of the 42,522 pixels valid in both. Required: >= 99.5% each.
    left, right, _ = pair
    dp = np.asarray(block_matching_disparity_pallas(
        jnp.asarray(left), jnp.asarray(right), num_disp=64, radius=5,
        interpret=True))
    dt = plain_disp
    vp, vt = dp > 0, dt > 0
    assert vp.mean() > 0.3
    agree = (vp == vt).mean()
    both = vp & vt
    close = (np.abs(dp[both] - dt[both]) <= 1e-3).mean()
    print(f"mask agreement {agree:.6f}, |d|<=1e-3 on {close:.6f} of "
          f"{both.sum()} both-valid pixels")
    assert agree >= 0.995, agree
    assert close >= 0.995, close


def test_plain_tracks_ground_truth(pair, plain_disp):
    # median subpixel error against the exact rendered disparity
    _, _, gt = pair
    d = plain_disp
    m = (d > 0) & (gt > 1.0) & (gt < 63.0)
    assert m.sum() > 2000
    err = np.abs(d[m] - gt[m])
    assert np.median(err) < 0.5, np.median(err)
    assert (err < 2.0).mean() > 0.9


def test_any_height_and_border_rows(pair):
    # the kernel's semantics accept any H (the TPU kernel needed H % 32 ==
    # 0): the first and last `radius` rows are invalid, the rest as on the
    # full image minus the rows whose window moved
    left, right, _ = pair
    lf = _sobel_x_prefilter(torch.as_tensor(left[:190]))
    rf = _sobel_x_prefilter(torch.as_tensor(right[:190]))
    d = stereo_bm.bm_plain(lf, rf, num_disp=64, radius=5).numpy()
    assert d.shape == (190, 256)
    assert (d[:5] == -1).all() and (d[-5:] == -1).all()
    assert (d[5:-5] > 0).mean() > 0.3
    # leftmost columns have no counterpart in the right image
    assert (d[:, :5] <= 0).all()


def test_textureless_rejected():
    flat = torch.full((64, 96), 0.5)
    d = stereo_bm.block_matching_disparity_bm(flat, flat, num_disp=32)
    assert (d.numpy() == -1).all()


def test_cpu_dispatch_does_not_count_and_other_devices_raise(pair):
    left, right, _ = pair
    before = stereo_bm.block_matching_disparity_bm.launches
    stereo_bm.block_matching_disparity_bm(
        torch.as_tensor(left[:64, :96]), torch.as_tensor(right[:64, :96]),
        num_disp=16)
    assert stereo_bm.block_matching_disparity_bm.launches == before
    meta = torch.empty((32, 64), device="meta")
    with pytest.raises(ValueError, match="no block-matching kernel"):
        stereo_bm.block_matching_disparity_bm(meta, meta, num_disp=16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        stereo_bm.bm_cuda(torch.zeros(8, 8), torch.zeros(8, 8), num_disp=16)

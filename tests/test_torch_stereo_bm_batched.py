"""The batched block-matching kernel module (scavislam_tpu_torch.ops.
stereo_bm, B streams in one launch).

On the CPU the batched plain version is held against the batched Pallas TPU
kernel it replaces, run in interpret mode at the production 64 disparities,
and against the single-image plain version per stream. The CUDA kernel
itself only runs on a card: ``tests/test_torch_cuda.py`` holds it against
both there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scavislam_tpu.core.camera import StereoCamera as JCam
from scavislam_tpu.io.synthetic import SyntheticSequence, default_room, varied_box
from scavislam_tpu.ops.stereo_pallas import block_matching_disparity_pallas_batched
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
def pairs():
    """Frame 0 of two scenes: (2, 192, 256) left and right."""
    fs = [SyntheticSequence(CAM, n_frames=1, planes=p).frame(0)
          for p in (default_room(), varied_box(1))]
    return (np.stack([np.array(f["left"]) for f in fs]),
            np.stack([np.array(f["right"]) for f in fs]))


@pytest.fixture(scope="module")
def plain_disp(pairs):
    left, right = pairs
    return stereo_bm.block_matching_disparity_bm_batched(
        torch.as_tensor(left), torch.as_tensor(right), num_disp=64,
        radius=5).numpy()


def test_plain_batched_matches_pallas_batched_kernel(pairs, plain_disp):
    # the single-image test's bar (tests/test_torch_stereo_bm.py): the
    # Pallas kernel sums the window rows as a banded matmul, the port row by
    # row, so a near-tie could take the other argmin. Required per stream:
    # valid masks agree and |Δ| <= 1e-3 px on >= 99.5% each.
    left, right = pairs
    dp = np.asarray(block_matching_disparity_pallas_batched(
        jnp.asarray(left), jnp.asarray(right), num_disp=64, radius=5,
        interpret=True))
    assert dp.shape == plain_disp.shape == (2, 192, 256)
    for b in range(2):
        vp, vt = dp[b] > 0, plain_disp[b] > 0
        assert vp.mean() > 0.3
        agree = (vp == vt).mean()
        both = vp & vt
        close = (np.abs(dp[b][both] - plain_disp[b][both]) <= 1e-3).mean()
        print(f"stream {b}: mask agreement {agree:.6f}, |d|<=1e-3 on "
              f"{close:.6f} of {both.sum()} both-valid pixels")
        assert agree >= 0.995, (b, agree)
        assert close >= 0.995, (b, close)


@pytest.mark.parametrize("height", [192, 190])
def test_plain_batched_equals_single_per_stream(pairs, plain_disp, height):
    # per stream, exactly the single-image plain version (any H)
    left, right = (torch.as_tensor(x[:, :height]) for x in pairs)
    lf = torch.stack([_sobel_x_prefilter(x) for x in left])
    rf = torch.stack([_sobel_x_prefilter(x) for x in right])
    db = stereo_bm.bm_plain_batched(lf, rf, num_disp=64, radius=5)
    for b in range(2):
        assert torch.equal(db[b], stereo_bm.bm_plain(lf[b], rf[b], 64, 5))
        d1 = stereo_bm.block_matching_disparity_bm(left[b], right[b], 64, 5)
        assert torch.equal(db[b], d1)
    if height == 192:
        assert np.array_equal(db.numpy(), plain_disp)


def test_batched_dispatch(pairs):
    # the CPU runs the plain version and counts nothing; a wrong rank, a
    # device with no kernel and a non-CUDA tensor at the kernel all raise
    left, right = (torch.as_tensor(x[:, :64, :96]) for x in pairs)
    before = stereo_bm.block_matching_disparity_bm_batched.launches
    single = stereo_bm.block_matching_disparity_bm.launches
    d = stereo_bm.block_matching_disparity_bm_batched(left, right, num_disp=16)
    assert d.shape == (2, 64, 96)
    assert stereo_bm.block_matching_disparity_bm_batched.launches == before
    assert stereo_bm.block_matching_disparity_bm.launches == single
    with pytest.raises(ValueError, match="B, H, W"):
        stereo_bm.block_matching_disparity_bm_batched(left[0], right[0])
    meta = torch.empty((2, 32, 64), device="meta")
    with pytest.raises(ValueError, match="no block-matching kernel"):
        stereo_bm.block_matching_disparity_bm_batched(meta, meta, num_disp=16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        stereo_bm.bm_cuda_batched(left, right, num_disp=16)

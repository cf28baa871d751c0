"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions. Every test here needs a CUDA card and skips without one.

This file imports no JAX (the machine with the card has none), so on a card:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.io.synthetic import (
    SyntheticSequence,
    closed_box,
    default_room,
    varied_box,
)
from scavislam_tpu_torch.models.frontend import StereoFrontend
from scavislam_tpu_torch.ops import stereo_bm
from scavislam_tpu_torch.ops.image import binomial3
from scavislam_tpu_torch.ops.stereo import _sobel_x_prefilter
from scavislam_tpu_torch.parallel.stream_pool import StreamPool
from scavislam_tpu_torch.utils.config import Config

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
@pytest.mark.parametrize("num_disp", [16, 32, 64, 128])
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
@pytest.mark.parametrize("shape", [(190, 256), (192, 250), (190, 237)])
def test_kernel_matches_plain_ragged_tiles(pair, shape):
    # H - 10 not a multiple of the tile's rows, W not one of its columns
    h, w = shape
    left, right = (x[:h, :w].contiguous() for x in pair)
    lf = _sobel_x_prefilter(binomial3(left))
    rf = _sobel_x_prefilter(binomial3(right))
    dk = stereo_bm.bm_cuda(lf, rf, num_disp=64, radius=5)
    dp = stereo_bm.bm_plain(lf, rf, num_disp=64, radius=5)
    torch.cuda.synchronize()
    assert torch.equal(dk, dp)
    with pytest.raises(ValueError, match="radius"):
        stereo_bm.bm_cuda(lf, rf, num_disp=64, radius=4)


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


@pytest.fixture
def stream_pairs(cuda_device):
    """Prefiltered frame 0 of three scenes, (3, 192, 256) each side."""
    scenes = (default_room(), varied_box(1), varied_box(2))
    fs = [SyntheticSequence(CAM, n_frames=1, planes=p,
                            device=cuda_device).frame(0) for p in scenes]
    lf = torch.stack([_sobel_x_prefilter(binomial3(f["left"])) for f in fs])
    rf = torch.stack([_sobel_x_prefilter(binomial3(f["right"])) for f in fs])
    return lf, rf


@pytest.mark.cuda
@pytest.mark.parametrize("height", [192, 190])
@pytest.mark.parametrize("num_disp", [32, 64])
def test_batched_kernel_matches_plain_and_single(stream_pairs, num_disp,
                                                 height):
    # the stream only offsets the planes: bit-for-bit the plain version and
    # the single-image kernel of each stream, at any H
    _batched_matches(stream_pairs, num_disp, height, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("num_disp", [16, 128])
def test_batched_kernel_ragged(stream_pairs, num_disp):
    # B = 3 at H = 190, W = 250: partial tiles on both axes
    _batched_matches(stream_pairs, num_disp, 190, 250)


def _batched_matches(stream_pairs, num_disp, height, width):
    lf, rf = (x[:, :height, :width].contiguous() for x in stream_pairs)
    db = stereo_bm.bm_cuda_batched(lf, rf, num_disp=num_disp, radius=5)
    dp = stereo_bm.bm_plain_batched(lf, rf, num_disp=num_disp, radius=5)
    d1 = torch.stack([stereo_bm.bm_cuda(lf[b], rf[b], num_disp=num_disp,
                                        radius=5) for b in range(len(lf))])
    torch.cuda.synchronize()
    assert (db > 0).float().mean() > 0.3
    assert torch.equal(db, dp)
    assert torch.equal(db, d1)


@pytest.mark.cuda
def test_entry_points_default_to_card(cuda_device):
    fe = StereoFrontend(CAM, Config())
    pool = StreamPool(CAM, Config(), n_streams=2)
    seq = SyntheticSequence(CAM, n_frames=1)
    for obj in (fe, pool, seq):
        assert obj.device.type == "cuda"
    assert seq.frame(0)["left"].is_cuda


@pytest.mark.cuda
def test_batched_dispatch_counts_and_matches_cpu(cuda_device):
    scenes = (closed_box(), varied_box(3))
    fs = [SyntheticSequence(CAM, n_frames=1, planes=p,
                            device=cuda_device).frame(0) for p in scenes]
    left = torch.stack([f["left"] for f in fs])
    right = torch.stack([f["right"] for f in fs])
    before = stereo_bm.block_matching_disparity_bm_batched.launches
    single = stereo_bm.block_matching_disparity_bm.launches
    dk = stereo_bm.block_matching_disparity_bm_batched(left, right, num_disp=64)
    assert stereo_bm.block_matching_disparity_bm_batched.launches == before + 1
    assert stereo_bm.block_matching_disparity_bm.launches == single
    dp = stereo_bm.block_matching_disparity_bm_batched(left.cpu(), right.cpu(),
                                                       num_disp=64)
    assert torch.equal(dk.cpu(), dp)
    with pytest.raises(ValueError, match="3-D float32 CUDA"):
        stereo_bm.bm_cuda_batched(left[0], right[0], num_disp=64)


def _ate(traj, gt):
    errs = [T.R @ (-Tg.R.numpy().T @ Tg.t.numpy()) + T.t
            for T, Tg in zip(traj, gt)]
    return float(np.sqrt((np.stack(errs) ** 2).sum(axis=1).mean()))


@pytest.mark.cuda
def test_pipelined_frontend_on_card(cuda_device):
    # depth 2 on the forward arc: every frame tracked, one single-image
    # kernel launch per frame
    n = 12
    seq = SyntheticSequence(CAM, n_frames=n, device=cuda_device)
    frames = [seq.frame(i) for i in range(n)]
    fe = StereoFrontend(CAM, Config(), device=cuda_device)
    before = stereo_bm.block_matching_disparity_bm.launches
    fe.process_first_frame(frames[0])
    poses = {0: fe._world_pose()}
    for f in frames[1:]:
        r = fe.process_frame_pipelined(f)
        if r is not None:
            assert r[0], r
            poses[r[2]] = fe._world_pose()
    for ok, _, fid, pose, _ in fe.flush_pipeline():
        assert ok
        if fid is not None:
            poses[fid] = pose
    assert sorted(poses) == list(range(n))
    assert stereo_bm.block_matching_disparity_bm.launches == before + n
    assert _ate([poses[i] for i in range(n)],
                [f["T_cw_gt"] for f in frames]) < 0.02


@pytest.mark.cuda
def test_stream_pool_on_card(cuda_device):
    # two streams, frames on the card: one batched launch per tick and no
    # single-image launch; both streams track
    n, B = 10, 2
    seqs = [SyntheticSequence(CAM, n_frames=n, planes=p, device=cuda_device)
            for p in (default_room(), varied_box(1))]
    ticks = [[{"frame_id": i, "left": f["left"], "right": f["right"]}
              for f in (q.frame(i) for q in seqs)] for i in range(n)]
    batched = stereo_bm.block_matching_disparity_bm_batched.launches
    single = stereo_bm.block_matching_disparity_bm.launches
    pool = StreamPool(CAM, Config(), n_streams=B, device=cuda_device)
    pool.process_first_frames(ticks[0])
    for tick in ticks[1:]:
        pool.process_frames(tick)
    pool.finish()
    assert stereo_bm.block_matching_disparity_bm_batched.launches == batched + n
    assert stereo_bm.block_matching_disparity_bm.launches == single
    for s in range(B):
        assert pool.alive[s]
        traj = pool.trajectories[s]
        assert len(traj) == n
        assert _ate([T for _, T in traj],
                    [seqs[s].poses[i] for i, _ in traj]) < 0.05

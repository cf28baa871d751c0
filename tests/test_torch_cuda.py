"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions, and the port's paths on the card (the backend's solve,
the place recognizer's describe and geometric check, threaded SlamSystem
runs, BP and CSBP stereo, k-means) against the CPU; a debug view's one
download; the sharded solve over the card listed twice; the stereo frame
step and the backend's programs as CUDA graph replays against their eager
calls. Every test here needs a CUDA card and skips without one.

This file imports no JAX (the machine with the card has none), so on a card:

    python -m pytest tests/test_torch_cuda.py -q
"""

import dataclasses
import warnings

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


def _ba_problem(device, seed=11, P=8, L=128, O=1024, E=16):
    """A seeded BA problem: 6 keyframes sliding along x in front of points
    at 3-9 m, every keyframe observing every point with 0.5 px noise, poses
    2.. and points perturbed."""
    from scavislam_tpu_torch.models.ba_solver import BAProblem
    rng = np.random.RandomState(seed)
    n_poses, n_pts = 6, 96
    f = {k: v.clone() for k, v in BAProblem.empty(P, L, O, E)._asdict().items()}
    cen = np.array([[0.25 * i, 0.0, 0.1 * i] for i in range(n_poses)])
    xyz = np.stack([rng.uniform(-1, 3, n_pts), rng.uniform(-1, 1, n_pts),
                    rng.uniform(3, 9, n_pts)], -1)
    anchors = np.arange(n_pts) % n_poses
    xa = xyz - cen[anchors]
    psi = np.stack([xa[:, 0] / xa[:, 2], xa[:, 1] / xa[:, 2], 1 / xa[:, 2]], -1)
    f["t"][:n_poses] = torch.as_tensor(-cen + np.r_[np.zeros((2, 3)),
                                       rng.randn(n_poses - 2, 3) * 0.02])
    f["pose_valid"][:n_poses] = True
    f["pose_fixed"][:2] = True
    f["psi"][:n_pts] = torch.as_tensor(psi + rng.randn(n_pts, 3) * 0.02)
    f["point_valid"][:n_pts] = True
    f["anchor_slot"][:n_pts] = torch.as_tensor(anchors)
    y = xyz[None] - cen[:, None]  # (poses, points, 3)
    uvu = np.stack([y[..., 0] / y[..., 2] * CAM.focal + CAM.pp[0],
                    y[..., 1] / y[..., 2] * CAM.focal + CAM.pp[1],
                    (y[..., 0] - CAM.baseline) / y[..., 2] * CAM.focal
                    + CAM.pp[0]], -1).reshape(-1, 3)
    n = n_poses * n_pts
    f["obs_pose"][:n] = torch.as_tensor(np.repeat(np.arange(n_poses), n_pts))
    f["obs_point"][:n] = torch.as_tensor(np.tile(np.arange(n_pts), n_poses))
    f["obs_uvu"][:n] = torch.as_tensor(uvu + rng.randn(n, 3) * 0.5)
    f["obs_valid"][:n] = True
    return BAProblem(**{k: v.to(device) for k, v in f.items()})


@pytest.mark.cuda
def test_solve_ba_on_card_matches_cpu(cuda_device):
    # the same problem solved on the card and on the CPU: R, t, psi within
    # 1e-3, chi2 within 1e-3 relative
    from scavislam_tpu_torch.models.ba_solver import solve_ba
    cam_params = (CAM.focal, CAM.pp[0], CAM.pp[1], CAM.baseline)
    out_c = solve_ba(cam_params, _ba_problem("cpu"), iters=2)
    out_g = solve_ba(cam_params, _ba_problem(cuda_device), iters=2)
    for a, b in zip(out_g[:3], out_c[:3]):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-3)
    for a, b in zip(out_g[3][:2], out_c[3][:2]):
        assert abs(float(a) - float(b)) <= 1e-3 * abs(float(b))
    assert float(out_g[3].chi2_final) < float(out_g[3].chi2_initial)


@pytest.mark.cuda
def test_padded_scatters_on_card(cuda_device):
    # ids padded with 1 << 30 are dropped on the card (no device assert) and
    # the padded rows leave every other row untouched
    from scavislam_tpu_torch.models.map_store import PoseTable, scatter_psi
    psi = torch.randn(64, 3, device=cuda_device)
    ids = torch.tensor([5, 1 << 30, 63, 1 << 30, -1], device=cuda_device)
    vals = torch.randn(5, 3, device=cuda_device)
    out = scatter_psi(psi, ids, vals)
    torch.cuda.synchronize()
    expect = psi.clone()
    expect[5], expect[63] = vals[0], vals[2]
    assert torch.equal(out, expect)
    poses = PoseTable.empty(16, device=cuda_device).set_many(
        ids, torch.randn(5, 3, 3, device=cuda_device), vals)
    torch.cuda.synchronize()
    assert poses.valid.nonzero().flatten().tolist() == [5]


@pytest.mark.cuda
def test_threaded_slam_system_on_card(cuda_device):
    # 20 frames threaded and pipelined: every frame tracked, the backend's
    # graph holds every keyframe after finish(), at least one solve adopted
    from scavislam_tpu_torch.pipeline.slam_system import SlamSystem, ate_rmse
    n = 20
    seq = SyntheticSequence(CAM, n_frames=n, device=cuda_device)
    frames = [seq.frame(i) for i in range(n)]
    cfg = Config()
    cfg = dataclasses.replace(cfg, ui=dataclasses.replace(cfg.ui,
                                                          parallax_thr=0.1))
    system = SlamSystem(CAM, cfg, threaded=True,
                        enable_loop_closure=False, pipelined=True,
                        pipeline_depth=3)
    try:
        system.process_first_frame(frames[0])
        for f in frames[1:]:
            assert system.process_frame(f)
        system.finish()
    finally:
        system.shutdown()
    g = system.backend.graph
    assert len(system.trajectory) == n
    assert sorted(g.vertices) == list(range(system.frontend.next_kf))
    assert len(g.solve_log) >= 1
    traj = sorted(system.trajectory, key=lambda e: e[0])
    assert ate_rmse(traj, [frames[i]["T_cw_gt"] for i, _ in traj]) < 0.05


def _describe_pair(device, vocab):
    """bow_describe of frames 0 and 3 of the forward arc on `device`, the
    frames rendered on the CPU (the renderer's texture hash differs between
    devices in the last bits of sin)."""
    from scavislam_tpu_torch.ops.descriptors import bow_describe
    seq = SyntheticSequence(CAM, n_frames=4, device="cpu")
    cam_params = (CAM.focal, CAM.pp[0], CAM.pp[1], CAM.baseline)
    v = torch.as_tensor(vocab, device=device)
    return [bow_describe(f["left"].to(device), f["disp_gt"].to(device), v,
                         cam_params)
            for f in (seq.frame(0), seq.frame(3))]


@pytest.mark.cuda
def test_bow_describe_on_card_matches_cpu(cuda_device):
    # the same frames described on the card and on the CPU: valid and
    # (u, v, d) equal, descriptors and xyz within 1e-5, words equal on
    # >= 99% of the valid rows
    from scavislam_tpu_torch.models.placerec import default_vocabulary
    vocab = default_vocabulary()
    for pg, pc in zip(_describe_pair(cuda_device, vocab),
                      _describe_pair("cpu", vocab)):
        pg, pc = pg.cpu().numpy(), pc.numpy()
        valid = pc[:, -1] > 0.5
        np.testing.assert_array_equal(pg[:, -1], pc[:, -1])
        np.testing.assert_array_equal(pg[:, 129:132], pc[:, 129:132])
        np.testing.assert_allclose(pg[valid, 1:129], pc[valid, 1:129],
                                   atol=1e-5)
        np.testing.assert_allclose(pg[valid, 132:135], pc[valid, 132:135],
                                   atol=1e-5, rtol=1e-6)
        assert (pg[valid, 0] == pc[valid, 0]).mean() >= 0.99


@pytest.mark.cuda
def test_geometric_check_on_card_matches_cpu(cuda_device):
    # the geometric-check program on the card and on the CPU with the same
    # hypotheses: the same match and inlier counts, R and t within 1e-4;
    # the recognizer enqueues it with no synchronizing call
    from scavislam_tpu_torch.models.placerec import (
        PlaceRecognizer,
        _geom_check_device,
        default_vocabulary,
        unpack_bow,
    )
    vocab = default_vocabulary()
    blocks = [p.numpy() for p in _describe_pair("cpu", vocab)]
    arrays = []
    for b in blocks:
        _, desc, _, xyz, valid = unpack_bow(b)
        arrays += [desc, xyz, valid]
    g = torch.Generator()
    g.manual_seed(7)
    idx = torch.randint(0, len(blocks[0]), (256, 3), generator=g)
    cam_params = (CAM.focal, CAM.pp[0], CAM.pp[1], CAM.baseline)
    outs = [_geom_check_device(
        idx.to(dev), *[torch.as_tensor(a, device=dev) for a in arrays],
        cam_params, 3.0).cpu().numpy() for dev in (cuda_device, "cpu")]
    assert outs[0][12:].tolist() == outs[1][12:].tolist()
    assert outs[1][13] > 30
    np.testing.assert_allclose(outs[0][:12], outs[1][:12], atol=1e-4)
    pr = PlaceRecognizer(CAM, vocab, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fut = pr._check_dispatch(*arrays)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert fut.result()[13] > 30


@pytest.mark.cuda
def test_threaded_slam_system_with_loop_closure_on_card(cuda_device):
    # 20 frames threaded and pipelined with loop closure on (the default):
    # every frame tracked, every keyframe indexed from its spawn's pr_packed
    # block (no describe by the recognizer)
    from scavislam_tpu_torch.pipeline.slam_system import SlamSystem, ate_rmse
    n = 20
    seq = SyntheticSequence(CAM, n_frames=n, device=cuda_device)
    frames = [seq.frame(i) for i in range(n)]
    cfg = Config()
    cfg = dataclasses.replace(cfg, ui=dataclasses.replace(cfg.ui,
                                                          parallax_thr=0.1))
    system = SlamSystem(CAM, cfg, threaded=True, pipelined=True,
                        pipeline_depth=3, pr_lossless=True)
    try:
        system.process_first_frame(frames[0])
        for f in frames[1:]:
            assert system.process_frame(f)
        system.finish()
    finally:
        system.shutdown()
    pr = system.place_recognizer
    assert not system.lost and len(system.trajectory) == n
    assert pr.counters["indexed"] == system.frontend.next_kf >= 2
    assert pr.counters["described"] == 0
    traj = sorted(system.trajectory, key=lambda e: e[0])
    assert ate_rmse(traj, [frames[i]["T_cw_gt"] for i, _ in traj]) < 0.05


def _pnm_pairs(root, n=6, seed=0):
    """n P5 stereo pairs under `root` at CAM's size; returns the pixels."""
    rng = np.random.RandomState(seed)
    w, h = CAM.size
    pairs = []
    for i in range(n):
        pair = rng.randint(0, 256, (2, h, w)).astype(np.uint8)
        for side, img in zip(("left", "right"), pair):
            with open(root / f"img_{i:06d}_{side}.pgm", "wb") as f:
                f.write(b"P5\n%d %d\n255\n" % (w, h))
                f.write(img.tobytes())
        pairs.append(pair)
    return pairs


@pytest.mark.cuda
def test_prefetched_frames_equal_files_on_card(cuda_device, tmp_path):
    # the grabber copies each stack on its own stream; the frontend's
    # stream waits on the frame's event, and what it reads is the files'
    # bytes
    from scavislam_tpu_torch.io.filegrabber import FileGrabber
    pairs = _pnm_pairs(tmp_path)
    fe = StereoFrontend(CAM, Config(), device=cuda_device)
    g = FileGrabber(str(tmp_path), base_pattern="img_.*", fmt="pgm",
                    device_prefetch=True, device=cuda_device)
    got = []
    for f in g:
        assert f["stacked_dev"].is_cuda and f["upload_event"] is not None
        got.append(fe._prefetched(f))
    g.close()
    torch.cuda.synchronize()
    assert len(got) == len(pairs)
    for s, want in zip(got, pairs):
        assert torch.equal(s, torch.as_tensor(want, device=cuda_device))


@pytest.mark.cuda
def test_rectify_stack_on_card_matches_cpu(cuda_device):
    from scavislam_tpu_torch.ops.rectify import _rectify_stack, build_rectify_map
    f = SyntheticSequence(CAM, n_frames=1, device="cpu").frame(0)
    stack = torch.stack([(torch.clamp(f[k], 0, 1) * 255 + 0.5).to(torch.uint8)
                         for k in ("left", "right")])
    ml = torch.as_tensor(build_rectify_map(CAM, (-0.04, 0.01, 0, 0, 0),
                                           (0, 0.01, 0)))
    mr = torch.as_tensor(build_rectify_map(CAM, (0.03, 0, 0, 0, 0), (0, 0, 0)))
    cpu = _rectify_stack(stack, ml, mr)
    card = _rectify_stack(stack.to(cuda_device), ml.to(cuda_device),
                          mr.to(cuda_device)).cpu()
    diff = (card.to(torch.int32) - cpu.to(torch.int32)).abs()
    assert int(diff.max()) <= 1
    assert float((diff == 0).float().mean()) >= 0.999


@pytest.mark.cuda
def test_grabber_upload_does_not_synchronize(cuda_device, tmp_path):
    # under sync debug mode "error" a synchronizing call in the producer
    # raises there, and next_frame re-raises it
    from scavislam_tpu_torch.io.filegrabber import FileGrabber
    pairs = _pnm_pairs(tmp_path, seed=1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g = FileGrabber(str(tmp_path), base_pattern="img_.*", fmt="pgm",
                        device_prefetch=True, device=cuda_device)
        frames = list(g)
        g.close()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(frames) == len(pairs)
    for f, want in zip(frames, pairs):
        f["upload_event"].synchronize()
        assert torch.equal(f["stacked_dev"],
                           torch.as_tensor(want, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["bp", "csbp"])
def test_bp_on_card_matches_cpu(cuda_device, method):
    # belief propagation (stereo method 3) and constant-space BP (4) at
    # 192x256, D = 64, on the binomial-smoothed pair: each call enqueues with
    # no synchronizing call, and the card agrees with the CPU as chip_smoke
    # phase 12 (b) requires: BP within 1e-3 px on >= 99% of pixels, CSBP
    # equal on >= 99%
    from scavislam_tpu_torch.ops.stereo_bp import (
        belief_propagation_disparity, constant_space_bp_disparity)
    f = SyntheticSequence(CAM, n_frames=1, device=cuda_device).frame(0)
    left, right = binomial3(f["left"]), binomial3(f["right"])
    if method == "bp":
        def fn(l, r):
            return belief_propagation_disparity(l, r, 64, iters=5, levels=4)
    else:
        def fn(l, r):
            return constant_space_bp_disparity(l, r, 64, 4, 4, 4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        card = fn(left, right)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert card.device == left.device
    cpu = fn(left.cpu(), right.cpu())
    if method == "bp":
        assert float((torch.abs(card.cpu() - cpu) <= 1e-3).float().mean()) >= 0.99
    else:
        assert float((card.cpu() == cpu).float().mean()) >= 0.99


# -- the mono mode on the card ------------------------------------------------ #

# the twin's mono test camera (tests/test_mono.py)
MONO_CAM = StereoCamera.create(130.0, (63.5, 47.5), (128, 96), 0.12)


def _mono_state(device, n=6):
    """A MonoFrontend after `n` synchronous frames of the forward arc on
    `device`, the next frame, and that frame's mono_step arguments, all on
    the device."""
    from scavislam_tpu_torch.models.mono_frontend import MonoFrontend
    seq = SyntheticSequence(MONO_CAM, n_frames=n + 1, kind="forward_arc",
                            step=0.035, device=device)
    fe = MonoFrontend(MONO_CAM, device=device)
    fe.process_first_frame(seq.frame(0))
    for i in range(1, n):
        ok, _ = fe.process_frame(seq.frame(i))
        assert ok, i
    nxt = seq.frame(n)
    cand = fe._cand_device(fe._collect_candidates())
    R, t = fe._pose_dev()
    args = (nxt["left"], R, t, fe._actkey_dev(), fe.poses, fe.points, fe.Lam,
            cand, fe._conv_dev, fe._pw_dev, fe._cam_params, fe._cam_statics,
            fe.levels, 2.0, 0.18)
    return fe, nxt, args


@pytest.mark.cuda
def test_mono_step_enqueues_without_sync_and_replays_as_graph(cuda_device):
    # one mono_step with every input on the card: no synchronizing call
    # (sync debug mode "error"); the step captured as a CUDA graph replays
    # to a packed vector and tables torch.equal to the eager call's
    from scavislam_tpu_torch.models.mono_step import mono_step
    _, _, args = _mono_state(cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = mono_step(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        mono_step(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = mono_step(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert float(eager.packed[25]) >= 15  # the frame tracks
    assert torch.equal(captured.packed, eager.packed)
    assert torch.equal(captured.Lam, eager.Lam)
    assert torch.equal(captured.points.psi, eager.points.psi)


@pytest.mark.cuda
def test_motion_only_ba_uv_on_card_matches_cpu(cuda_device):
    # a noisy uv problem with outliers on the card and on the CPU: pose and
    # residuals within 1e-5, chi2 within 1e-5 relative
    from scavislam_tpu_torch.core.lie import SE3
    from scavislam_tpu_torch.models.pose_optimizer import motion_only_ba_uv
    rng = np.random.RandomState(0)
    n = 512
    xyz = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(3, 9, n)], -1).astype(np.float32)
    T = SE3.exp(torch.tensor([0.05, 0.02, 0.08, -0.02, 0.03, 0.01]))
    y = xyz @ T.R.numpy().T + T.t.numpy()
    cam = (130.0, 63.5, 47.5)
    obs = np.stack([y[:, 0] / y[:, 2] * cam[0] + cam[1],
                    y[:, 1] / y[:, 2] * cam[0] + cam[2]], -1)
    obs = (obs + rng.randn(n, 2) * 0.3).astype(np.float32)
    obs[:40] += 25.0
    w = rng.uniform(0.05, 1.0, n).astype(np.float32)
    valid = rng.rand(n) > 0.1

    def run(dev):
        return motion_only_ba_uv(
            cam, SE3.identity(device=dev), torch.tensor(xyz, device=dev),
            torch.tensor(obs, device=dev), torch.tensor(w, device=dev),
            torch.tensor(valid, device=dev))

    rg, rc = run(cuda_device), run("cpu")
    np.testing.assert_allclose(rg.T.R.cpu().numpy(), rc.T.R.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(rg.T.t.cpu().numpy(), rc.T.t.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(rg.residuals.cpu().numpy(),
                               rc.residuals.numpy(), atol=1e-4)
    assert abs(float(rg.chi2) - float(rc.chi2)) <= 1e-5 * float(rc.chi2)


@pytest.mark.cuda
def test_mono_relocalize_restores_tables_after_failed_confirm(cuda_device):
    # a relocalization whose confirm fails (a noise frame, the recognizer's
    # scoring forced to name keyframe 0) leaves the frontend with the very
    # tables it had, bitwise: the frame step never writes them in place
    from scavislam_tpu_torch.models import mono_loop
    fe, _, _ = _mono_state(cuda_device)
    pr = mono_loop.make_mono_place_recognizer(fe, score_thr=0.05)
    pr._score = lambda words, exclude: {0: 1.0}
    points, lam = fe.points, fe.Lam
    psi0, lam0 = points.psi.clone(), lam.clone()
    pose0 = (fe._R_cw.copy(), fe._t_cw.copy(), fe.actkey_id)
    rng = np.random.RandomState(1)
    noise = {"frame_id": 99,
             "left": torch.tensor(rng.rand(96, 128).astype(np.float32),
                                  device=cuda_device)}
    assert not fe.relocalize(pr, noise)
    torch.cuda.synchronize()
    assert fe.points is points and fe.Lam is lam
    assert torch.equal(points.psi, psi0) and torch.equal(lam, lam0)
    np.testing.assert_array_equal(fe._R_cw, pose0[0])
    np.testing.assert_array_equal(fe._t_cw, pose0[1])
    assert fe.actkey_id == pose0[2]


@pytest.mark.cuda
def test_debug_render_downloads_once_on_card(cuda_device):
    # every debug view of a 512x384 frame is computed on the card and
    # downloaded once: one synchronizing call under sync debug mode "warn"
    import warnings

    from scavislam_tpu_torch.apps.visualize import (
        DEBUG_MODES,
        render_debug_image,
    )
    cfg = Config()
    cam = StereoCamera.create(cfg.cam.f, (cfg.cam.px, cfg.cam.py),
                              (cfg.cam.width, cfg.cam.height),
                              cfg.cam.baseline)
    seq = SyntheticSequence(cam, n_frames=3, step=0.02, device=cuda_device)
    fe = StereoFrontend(cam, cfg, device=cuda_device)
    fe.process_first_frame(seq.frame(0))
    for i in (1, 2):
        assert fe.process_frame(seq.frame(i))[0]
    torch.cuda.synchronize()
    for mode in range(len(DEBUG_MODES)):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                img = render_debug_image(mode, 0, fe)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        syncs = [w for w in caught if "synchroniz" in str(w.message)]
        assert len(syncs) == 1, (DEBUG_MODES[mode], [str(w.message)
                                                     for w in caught])
        assert img.shape == (384, 512, 3)


@pytest.mark.cuda
def test_sharded_ba_on_card_matches_solve_ba(cuda_device):
    # build_sharded_ba over the card listed twice against solve_ba on the
    # card: the shards' partial systems sum to the whole, within 1e-5
    from scavislam_tpu_torch.models.ba_solver import solve_ba
    from scavislam_tpu_torch.parallel.multistream import (
        build_sharded_ba,
        make_mesh,
    )
    cam_params = (CAM.focal, CAM.pp[0], CAM.pp[1], CAM.baseline)
    prob = _ba_problem(cuda_device)
    R1, t1, psi1, st = solve_ba(cam_params, prob, iters=2)
    mesh = make_mesh(2, dp=1, devices=[cuda_device] * 2)
    R2, t2, psi2, chi2 = build_sharded_ba(mesh, cam_params, iters=2)(prob)
    for a, b in ((R2, R1), (t2, t1), (psi2, psi1)):
        assert a.device == cuda_device
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   atol=1e-5)
    assert abs(float(chi2) - float(st.chi2_final)) <= 1e-5 * float(
        st.chi2_final)


@pytest.mark.cuda
def test_train_vocabulary_on_card_matches_cpu(cuda_device):
    # Lloyd's k-means on the card and on the CPU from the same initial
    # centres: the vocabularies within 1e-4. The descriptors lie in 64 tight
    # clusters, so that no assignment is a near-tie that the two devices'
    # summation orders could break differently
    from scavislam_tpu_torch.models.placerec import train_vocabulary
    rng = np.random.RandomState(5)
    c = rng.randn(64, 128)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    d = (c[rng.randint(0, 64, 6000)] + 0.05 * rng.randn(6000, 128))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    init = d[rng.choice(len(d), 64, replace=False)]
    v_cpu = train_vocabulary(d, k=64, iters=10, init_centers=init,
                             device="cpu")
    v_card = train_vocabulary(d, k=64, iters=10, init_centers=init,
                              device=cuda_device)
    np.testing.assert_allclose(v_card, v_cpu, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(v_card, axis=1), 1.0,
                               atol=1e-4)


# -- the card against the CPU on the same frames (chip_smoke.py phase 15) -- #
# tests/test_torch_slam_system.py's 12 frames, camera and configuration,
# the frames rendered once on the CPU and quantized
# (probes/pose_lm_probe.py, chip_smoke.parity_frames)


@pytest.mark.cuda
def test_frontend_step_on_card_matches_cpu(cuda_device):
    # one frame step (stereo method 2: the kernel on the card, its plain
    # version on the CPU) from one shared state, a CPU frontend's after 6
    # frames loaded into a card and a CPU frontend: the pyramid and the
    # disparity equal, the match counts, the matched set and the gates
    # equal, the observations within 1e-3 px, then R, t and T_cak within
    # 1e-4 (tests/test_torch_frontend.py's bar against JAX)
    from probes import pose_lm_probe as plp
    from scavislam_tpu_torch.models.frontend import CAND_CAP
    frames = plp.frames(7)
    cfg = plp.config()
    src = StereoFrontend(plp.CAM, cfg, device="cpu")
    src.process_first_frame(frames[0])
    for f in frames[1:6]:
        assert src.process_frame(f)[0]
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        fe = plp.load_shared_state(StereoFrontend(plp.CAM, cfg, device=dev),
                                   src, dev)
        outs.append(fe._run_step(frames[6], fe._collect_candidates()))
    og, oc = outs
    for a, b in zip(og.pyr + (og.disp,), oc.pyr + (oc.disp,)):
        assert torch.equal(a.cpu(), b)
    pg, pc = og.packed.cpu().numpy(), oc.packed.numpy()
    C = CAND_CAP
    assert pc[24] > 100 and pc[25] > 100
    assert pg[24:26].tolist() == pc[24:26].tolist()
    np.testing.assert_array_equal(pg[34:34 + 2 * C], pc[34:34 + 2 * C])
    np.testing.assert_allclose(pg[34 + 2 * C:], pc[34 + 2 * C:], atol=1e-3)
    np.testing.assert_allclose(pg[0:24], pc[0:24], atol=1e-4)


@pytest.mark.cuda
def test_register_packed_on_card_matches_cpu(cuda_device):
    # the fused two-pass registration (backend._build_register_packed) on
    # the newest keyframe's snapshot of a 12-frame CPU run, against the
    # tables: on the card and on the CPU the pass-1 gate count, the gate and
    # the levels equal, observations within 1e-3 px and the pose within
    # 1e-4 (tests/test_torch_backend.py's bars against JAX)
    from probes import pose_lm_probe as plp
    from scavislam_tpu_torch.models import backend as tbe
    from scavislam_tpu_torch.models.map_store import PointTable, PoseTable
    from scavislam_tpu_torch.pipeline.slam_system import SlamSystem
    frames = plp.frames()
    cfg = plp.config()
    cfg = dataclasses.replace(cfg, graph=dataclasses.replace(
        cfg.graph, inner_window=2))
    system = SlamSystem(plp.CAM, cfg, threaded=False,
                        enable_loop_closure=False, device="cpu")
    system.process_first_frame(frames[0])
    for f in frames[1:]:
        assert system.process_frame(f)
    system.finish()
    be = system.backend
    kf = max(be.keyframe_snapshots)
    snap = be.keyframe_snapshots[kf]
    pts, poses = be._last_tables
    cand = np.flatnonzero(pts.valid.numpy())[:1024]
    T0 = be.graph.vertices[kf].T
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        sn = {"pyr": tuple(x.to(dev) for x in snap["pyr"]),
              "disp": snap["disp"].to(dev)}
        _, fut = be._match_and_align_dispatch(
            sn, T0, cand, PointTable(*(x.to(dev) for x in pts)),
            PoseTable(*(x.to(dev) for x in poses)))
        outs.append(np.asarray(fut.result()))
    pg, pc = outs
    C = tbe.CAND_CAP
    assert pg.shape == pc.shape == (1 + 5 * C + 12,)
    assert pg[0] == pc[0] >= 10
    np.testing.assert_array_equal(pg[1:1 + C], pc[1:1 + C])
    np.testing.assert_allclose(pg[1 + C:1 + 4 * C], pc[1 + C:1 + 4 * C],
                               atol=1e-3)
    np.testing.assert_array_equal(pg[1 + 4 * C:1 + 5 * C],
                                  pc[1 + 4 * C:1 + 5 * C])
    np.testing.assert_allclose(pg[-12:], pc[-12:], atol=1e-4)


@pytest.mark.cuda
def test_slam_system_on_card_matches_cpu(cuda_device):
    # tests/test_torch_slam_system.py's 12 frames, unthreaded with loop
    # closure on and the RANSAC draws from one CPU generator on both
    # devices (chip_smoke.parity_run): the same keyframes, solves, edges,
    # loops and backend counters, every frame tracked, ATE within 1%
    import chip_smoke
    from probes import pose_lm_probe as plp
    frames = plp.frames()
    before = stereo_bm.block_matching_disparity_bm.launches
    card = chip_smoke.parity_run(plp.CAM, plp.config(), cuda_device, frames)
    assert stereo_bm.block_matching_disparity_bm.launches == before + 12
    host = chip_smoke.parity_run(plp.CAM, plp.config(), "cpu", frames)
    cmp = chip_smoke.parity_compare(card, host, chip_smoke.SPIN_COUNTS)
    assert cmp["misses"] == [], cmp
    assert card["counters"] == host["counters"]
    assert host["keyframes"] >= 2 and host["solves"] >= 1


# -- the stereo frame step as a CUDA graph ---------------------------------- #

@pytest.mark.cuda
def test_frontend_step_replays_as_graph(cuda_device):
    # one frame step (stereo method 2) from a 4-frame state on the card:
    # enqueued with no synchronizing call (sync debug mode "error"), then
    # captured by StepGraph and replayed, also with no synchronizing call:
    # every output torch.equal to the eager call's, the block-matching
    # counter moved by one for the replay
    import chip_smoke
    from probes import pose_lm_probe as plp
    from scavislam_tpu_torch.models.frontend_step import frontend_step
    from scavislam_tpu_torch.models.step_graph import StepGraph
    frames = plp.frames(6)
    fe = StereoFrontend(plp.CAM, plp.config(), device=cuda_device)
    fe.process_first_frame(frames[0])
    for f in frames[1:4]:
        assert fe.process_frame(f)[0]
    args, kwargs = chip_smoke._step_args(fe, frames[4])
    graph = StepGraph()
    graph(*args, **kwargs)  # the capture; its result is the warm-up's
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = frontend_step(*args, **kwargs)
        before = stereo_bm.block_matching_disparity_bm.launches
        replayed = graph(*args, **kwargs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert (graph.captures, graph.replays) == (1, 1)
    assert stereo_bm.block_matching_disparity_bm.launches == before + 1
    assert float(eager.packed[25]) >= 20  # the frame tracks
    for name, a, b in zip(eager._fields, replayed, eager):
        for x, y in zip(torch.utils._pytree.tree_leaves(a),
                        torch.utils._pytree.tree_leaves(b)):
            assert torch.equal(x, y), name


@pytest.mark.cuda
def test_stereo_frontend_graph_matches_eager_loop(cuda_device):
    # 12 frames through StereoFrontend on the card (the step captured at
    # the first frame, replayed at the other 11) against the same frontend
    # stepping frontend_step eagerly: the same poses at every frame, bit
    # for bit, and the same keyframes
    from probes import pose_lm_probe as plp
    from scavislam_tpu_torch.models.frontend_step import frontend_step
    frames = plp.frames()
    runs = []
    for eager in (False, True):
        fe = StereoFrontend(plp.CAM, plp.config(), device=cuda_device)
        if eager:
            fe._step = frontend_step
        fe.process_first_frame(frames[0])
        poses = [fe._world_pose()]
        for f in frames[1:]:
            assert fe.process_frame(f)[0]
            poses.append(fe._world_pose())
        runs.append((fe, poses))
    (fg, pg), (fe, pe) = runs
    assert (fg._step.captures, fg._step.replays) == (1, len(frames) - 1)
    assert fg.next_kf == fe.next_kf >= 2
    for a, b in zip(pg, pe):
        assert np.array_equal(a.R, b.R) and np.array_equal(a.t, b.t)


@pytest.mark.cuda
def test_backend_programs_replay_as_graphs(cuda_device):
    # the backend's solve and registration after a 12-frame unthreaded
    # SlamSystem on the card, each program's graph replay (GraphedFn)
    # against its eager call on the same inputs: the registration
    # torch.equal; the solve within test_solve_ba_on_card_matches_cpu's
    # bars (R, t, psi within 1e-3, chi2 within 1e-3 relative): its
    # index_add_ sums are unordered atomics, and a replay differs from the
    # eager call in the last bits
    from probes import pose_lm_probe as plp
    from scavislam_tpu_torch.models import slam_graph as tsg
    from scavislam_tpu_torch.models.step_graph import GraphedFn
    from scavislam_tpu_torch.pipeline.slam_system import SlamSystem
    frames = plp.frames()
    system = SlamSystem(plp.CAM, plp.config(), threaded=False,
                        enable_loop_closure=False, device=cuda_device)
    system.process_first_frame(frames[0])
    for f in frames[1:]:
        assert system.process_frame(f)
    system.finish()
    be = system.backend
    cam_params, buf, caps = be.graph.last_problem
    eager = tsg._solve_packed_flat(cam_params, buf, caps, 2, 3.0)
    solve = GraphedFn(tsg._solve_packed_flat)
    solve(cam_params, buf, caps, 2, 3.0)
    replayed = solve(cam_params, buf, caps, 2, 3.0)
    assert (solve.captures, solve.replays) == (1, 1)
    rp, ep = replayed.cpu().numpy(), eager.cpu().numpy()
    np.testing.assert_allclose(rp[:-2], ep[:-2], atol=1e-3)
    np.testing.assert_allclose(rp[-2:], ep[-2:], rtol=1e-3)
    kf = max(be.keyframe_snapshots)
    pts, poses = be._last_tables
    cand = np.flatnonzero(pts.valid.cpu().numpy())[:1024]
    outs = [be._match_and_align_dispatch(be.keyframe_snapshots[kf],
                                         be.graph.vertices[kf].T, cand, pts,
                                         poses)[1].result().copy()
            for _ in range(3)]
    (graph,) = be._register_graphs.values()
    assert graph.replays >= 2
    assert outs[0][0] > 0  # pass 1 gated matches
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[2], outs[0])


# -- the multistream steps as one batched program --------------------------- #

def _pool_ticks(n, scenes, device):
    seqs = [SyntheticSequence(CAM, n_frames=n, planes=p, device=device)
            for p in scenes]
    ticks = [[{"frame_id": i, "left": f["left"], "right": f["right"]}
              for f in (q.frame(i) for q in seqs)] for i in range(n)]
    return seqs, ticks


@pytest.mark.cuda
def test_stream_pool_replays_one_graph_per_tick(cuda_device):
    # three streams on the card: the tick's program (prefilter, batched
    # kernel, vmapped step) captured once at the first tick and replayed at
    # every other, one batched launch per tick; then, from the state of
    # the last tick, the replay against the eager vmapped program on the
    # same inputs: every output torch.equal (the same kernels in the same
    # order), the eager program run with vmap's per-sample fallback warning
    # on and every warning raised (the card's own route, the triangular
    # solves, batches without a fallback)
    n, B = 8, 3
    seqs, ticks = _pool_ticks(n, (default_room(), varied_box(1),
                                  varied_box(2)), cuda_device)
    pool = StreamPool(CAM, Config(), n_streams=B, device=cuda_device)
    step = pool.step
    rec = {}

    def record(*args):
        rec["args"] = args
        return step(*args)

    pool.step = record
    batched = stereo_bm.block_matching_disparity_bm_batched.launches
    pool.process_first_frames(ticks[0])
    for tick in ticks[1:]:
        pool.process_frames(tick)
    pool.finish()
    (graph,) = step.graphs
    assert (graph.captures, graph.replays) == (1, n - 1)
    assert stereo_bm.block_matching_disparity_bm_batched.launches == batched + n
    for s in range(B):
        assert pool.alive[s]
        traj = pool.trajectories[s]
        assert len(traj) == n
        assert _ate([T for _, T in traj],
                    [seqs[s].poses[i] for i, _ in traj]) < 0.05
    args = rec["args"]
    torch.cuda.synchronize()
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            eager = step.program(*args)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    replayed = step(*args)
    torch.cuda.synchronize()
    assert graph.replays == n
    for name, a, b in zip(eager._fields, replayed, eager):
        for x, y in zip(torch.utils._pytree.tree_leaves(a),
                        torch.utils._pytree.tree_leaves(b)):
            assert torch.equal(x, y), name

"""The dense tracker's inverse-compositional evaluation
(``ops/dense_ic.py``). On the CPU: the tracker's ``_ic_pass`` and the
operator's CPU implementation against the plain version, the operator's
vmap rule against a loop of plain calls, its input checks and the launch
counter. On a card: the CUDA
kernels against the plain version at the benchmark cells' shapes and on
edge cases, the batched call against per-lane calls (mapped, unmapped at
lane stride 0 and mapped at another axis), graph replays, the level's LM
with each, and the launches of a step and of a tick replay.

This file imports no JAX, so on a card:

    python -m pytest tests/test_torch_dense_ic.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.core.lie import SE3
from scavislam_tpu_torch.io.synthetic import SyntheticSequence
from scavislam_tpu_torch.models import dense_tracker as tdt
from scavislam_tpu_torch.models import frontend_step as tfs
from scavislam_tpu_torch.ops import dense_ic
from scavislam_tpu_torch.ops.image import build_pyramid, sobel_xy

from probes import dense_ic_cases as cases

CAM = StereoCamera.create(195.0, (127.0, 95.0), (256, 192), 0.12)

# the kernel sums each lane in float64 and rounds once to float32: against
# the float64 sum of the plain version's own per-point terms it differs by
# that rounding (2^-24 of an entry) and the order of the float64 sums
# (measured <= 5.5e-8 of the largest entry at the cells' shapes, NVIDIA
# H100); the median in-frame point moves the trace of H by >= 2e-5 of it
# (asserted > 10x this bar), so a dropped or double-counted point fails it
F64_TOL = 2e-7
# against the plain version itself, whose products sum in float32 in
# cuBLAS's order (measured <= 2.6e-6 of the largest entry)
PLAIN_TOL = 1e-5
# the benchmark's median bar on a frame step's pose (step_pose_gap_median)
POSE_TOL = 1e-4


def _cloud_levels(device, cam=CAM, subs=tfs.DENSE_SUBS):
    """Per level: (cam, frame 1's image, frame 0's cloud, intensities,
    template Jacobian, valid), from the exact disparity."""
    seq = SyntheticSequence(cam, n_frames=2, kind="wander", step=0.06,
                            device=device)
    f0, f1 = seq.frame(0), seq.frame(1)
    cams = [cam.scale_level(lv) for lv in range(3)]
    cam_params = tuple((c.focal, c.pp[0], c.pp[1], c.baseline) for c in cams)
    pyr0 = build_pyramid(f0["left"], 3)
    dxs, dys = zip(*[sobel_xy(p) for p in pyr0])
    clouds, valids, intens, Js = tfs._cloud_state(
        pyr0, f0["disp_gt"], torch.eye(3, device=device),
        torch.zeros(3, device=device), cam_params, 3, dxs, dys, subs)
    pyr1 = build_pyramid(f1["left"], 3)
    return [(cams[lv], pyr1[lv], clouds[lv], intens[lv], Js[lv], valids[lv])
            for lv in range(3)]


def _pose(seed, sigma, device="cpu"):
    if sigma == 0:
        return torch.eye(3, device=device), torch.zeros(3, device=device)
    T = SE3.exp(torch.as_tensor(
        np.random.default_rng(seed).normal(0, sigma, 6).astype(np.float32),
        device=device))
    return T.R, T.t


def _op(cam, img, R, t, c, i, J, v):
    """The operator on one lane."""
    out = dense_ic.dense_ic(img[None], R[None], t[None], c[None], i[None],
                            J[None], v[None], cam.focal, *cam.pp)
    return tuple(x[0] for x in out)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def cpu_levels():
    return _cloud_levels("cpu")


# -- on the CPU ---------------------------------------------------------------- #

@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("sigma", [0.0, 0.004])
def test_op_cpu_implementation_is_plain(cpu_levels, level, sigma):
    # the operator on the CPU, and the tracker's _ic_pass there, bit for
    # bit the plain version
    cam, img, c, i, J, v = cpu_levels[level]
    R, t = _pose(level, sigma)
    plain = cases.plain_lane(cam, img, R, t, c, i, J, v)
    assert float(plain[2]) > 0
    assert _equal(_op(cam, img, R, t, c, i, J, v), plain)
    assert _equal(tdt._ic_pass(cam, img, R, t, c, i, J, v), plain)


VMAP_DIMS = ["all_at_0", "pose_unmapped", "cloud_at_1"]


def _three_lanes(level, dims):
    """The level's cloud on three images and poses, laid out as `dims`
    says, for vmap over the operator: (in_dims, the lanes' arguments,
    each lane's own (img, R, t, c, i, J, v))."""
    cam, img, c, i, J, v = level
    imgs = torch.stack([img, img.flip(-1).contiguous(), 0.5 * img])
    poses = [_pose(s, 0.004, img.device) for s in range(3)]
    R = torch.stack([p[0] for p in poses])
    t = torch.stack([p[1] for p in poses])
    cs, i_s, Js, vs = (torch.stack([x, x, x]) for x in (c, i, J, v))
    in_dims = (0, 0, 0, 0, 0, 0, 0)
    if dims == "pose_unmapped":
        R, t, in_dims = R[0], t[0], (0, None, None, 0, 0, 0, 0)
    if dims == "cloud_at_1":
        cs, i_s, Js, vs = (x.movedim(0, 1) for x in (cs, i_s, Js, vs))
        in_dims = (0, 0, 0, 1, 1, 1, 1)
    lanes = [(imgs[k], R if R.dim() == 2 else R[k], t if t.dim() == 1
              else t[k], c, i, J, v) for k in range(3)]
    return in_dims, (imgs, R, t, cs, i_s, Js, vs), lanes


@pytest.mark.parametrize("dims", VMAP_DIMS)
def test_vmap_over_op_equals_loop_of_plain_calls(cpu_levels, dims):
    # the vmap rule folds the mapped axis into the operator's lanes: three
    # lanes equal, bit for bit, a loop of plain calls; an unmapped
    # argument serves every lane
    cam = cpu_levels[1][0]
    in_dims, args, lanes = _three_lanes(cpu_levels[1], dims)
    out = torch.func.vmap(lambda *a: _op(cam, *a), in_dims=in_dims)(*args)
    for k, lane in enumerate(lanes):
        assert _equal([x[k] for x in out], cases.plain_lane(cam, *lane))


def _bad_inputs(case, lanes=2, n=16, h=12, w=16):
    args = dict(img=torch.rand(lanes, h, w), R=torch.eye(3).repeat(lanes, 1, 1),
                t=torch.zeros(lanes, 3), xyz_ref=torch.rand(lanes, n, 3) + 1,
                i_ref=torch.rand(lanes, n), J_ref=torch.rand(lanes, n, 6),
                valid=torch.ones(lanes, n, dtype=torch.bool))
    if case == "dtype":
        args["img"] = args["img"].double()
    elif case == "valid_dtype":
        args["valid"] = args["valid"].float()
    elif case == "shape":
        args["J_ref"] = args["J_ref"][..., :5]
    elif case == "lanes":
        args["R"] = torch.eye(3).repeat(lanes + 1, 1, 1)
    elif case == "points":
        args["i_ref"] = args["i_ref"][:, 1:]
    elif case == "contiguity":
        args["xyz_ref"] = args["xyz_ref"].transpose(1, 2).contiguous() \
            .transpose(1, 2)
    elif case == "unlaned":
        args["img"] = args["img"][0]
    return args


@pytest.mark.parametrize("case", ["dtype", "valid_dtype", "shape", "lanes",
                                  "points", "contiguity", "unlaned"])
def test_op_rejects_what_the_kernel_does_not_take(case):
    args = _bad_inputs(case)
    with pytest.raises(ValueError):
        dense_ic.dense_ic(*args.values(), 100.0, 8.0, 6.0)
    # the same arguments made whole pass
    dense_ic.dense_ic(*_bad_inputs(None).values(), 100.0, 8.0, 6.0)


def test_launch_counter_stays_zero_on_the_cpu(cpu_levels):
    # the level's LM on the CPU, alone and as lanes of a vmapped program,
    # runs the plain version and launches nothing
    before = dense_ic.ic_pass.launches
    cam, img, c, i, J, v = cpu_levels[2]
    R0, t0 = torch.eye(3), torch.zeros(3)
    tdt._lm_level_ic(cam, img, c, i, J, v, R0, t0)
    with tdt.lanes():
        torch.func.vmap(lambda *a: tdt._lm_level_ic(cam, *a, R0, t0,
                                                     max_iters=2))(
            *(torch.stack([x, x]) for x in (img, c, i, J, v)))
    assert dense_ic.ic_pass.launches == before


def test_blocks_per_lane():
    # one point a thread up to 256 blocks, whatever the lanes
    assert [dense_ic.blocks_per_lane(n) for n in
            (0, 1, 256, 257, 3072, 12288, 49152, 65536, 10 ** 6)] == \
        [1, 1, 1, 2, 12, 48, 192, 256, 256]


def _edge_cloud(device):
    """Points at the frame's edges and depths, with focal 1 and principal
    point 0 at the identity pose (so u = x / z exactly), on a 24x20 image:
    (args, the in-frame mask the plain semantics give)."""
    w, h = 24, 20
    one = np.float32(1.0)
    below = np.nextafter(np.float32(2.0), np.float32(0.0))
    u_ok, v_ok = 7.25, 9.5
    rows = [  # (x, y, z, valid, in frame)
        (2.0, v_ok, one, True, True),                    # u on the border
        (below, v_ok, one, True, False),                 # just outside
        (w - 2.0, v_ok, one, True, False),               # u = w - 2
        (np.nextafter(np.float32(w - 2.0), np.float32(0)), v_ok, one, True,
         True),
        (u_ok, 2.0, one, True, True),
        (u_ok, h - 2.0, one, True, False),
        (u_ok, np.nextafter(np.float32(h - 2.0), np.float32(0)), one, True,
         True),
        (u_ok * 1e-6, v_ok * 1e-6, 1e-6, True, False),   # z = 1e-6
        (u_ok * 2e-6, v_ok * 2e-6, 2e-6, True, True),    # just deeper
        (0.0, 0.0, 0.0, True, False),                    # z = 0
        (-u_ok, -v_ok, -1.0, True, False),               # behind
        (u_ok, v_ok, one, False, False),                 # invalid
        (float("nan"), v_ok, one, True, False),          # no projection
        (1e30, v_ok, one, True, False),                  # far outside
        (u_ok, v_ok, one, True, True),
        (w - 3.5, h - 3.5, one, True, True),
    ]
    g = np.random.default_rng(5)
    n = len(rows)
    xyz = torch.tensor([[r[0], r[1], r[2]] for r in rows],
                       dtype=torch.float32, device=device)
    args = (torch.as_tensor(g.random((h, w)), dtype=torch.float32,
                            device=device),
            torch.eye(3, device=device), torch.zeros(3, device=device), xyz,
            torch.as_tensor(g.random(n), dtype=torch.float32, device=device),
            torch.as_tensor(g.normal(0, 1, (n, 6)), dtype=torch.float32,
                            device=device),
            torch.tensor([r[3] for r in rows], device=device))
    return args, torch.tensor([r[4] for r in rows], device=device)


def _f64_sums(cam, img, R, t, c, i, J, v):
    """The plain version's per-point mask and residuals summed in float64."""
    sums, _, _, inside = cases.f64_reference(cam, img, R, t, c, i, J, v)
    return sums, inside


EDGE_CAM = StereoCamera(1.0, (0.0, 0.0), (24, 20), 0.1)


def test_plain_edge_semantics():
    # the border (u, v in [2, size - 2)), the depth (z > 1e-6), the valid
    # flag and points with no projection, as the plain version sees them;
    # the card test holds the kernel to the same points
    args, mask = _edge_cloud("cpu")
    sums, inside = _f64_sums(EDGE_CAM, *args)
    assert torch.equal(inside, mask)
    got = cases.plain_lane(EDGE_CAM, *args)
    for a, b in zip(got, sums):
        np.testing.assert_allclose(a.double(), b, rtol=1e-6, atol=1e-6)
    none = cases.plain_lane(EDGE_CAM, *args[:-1], torch.zeros_like(args[-1]))
    assert all(not x.any() for x in none)


# -- on a card ------------------------------------------------------------------ #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the dense_ic kernels have no CPU "
                    "mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def cell_levels():
    """The benchmark cells' clouds on the card: {"nc": B = 1, "fleet":
    B = 8}, per level (cam, img, xyz, i_ref, J, valid) with a lane axis
    (probes/dense_ic_cases.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    return {cell: cases.cell_levels(dev, streams, subs)
            for cell, (streams, subs) in cases.CELLS.items()}


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["nc", "fleet"])
@pytest.mark.parametrize("level", [0, 1, 2])
def test_kernel_matches_plain_at_cell_shapes(cuda_device, cell_levels, cell,
                                             level):
    cam, img, c, i, J, v = cell_levels[cell][level]
    B = img.shape[0]
    for sigma in (0.0, 0.003):
        poses = [_pose(s, sigma, cuda_device) for s in range(B)]
        R = torch.stack([p[0] for p in poses])
        t = torch.stack([p[1] for p in poses])
        args = (img, R, t, c, i, J, v)
        kernel = cases.over_lanes(cases.kernel_lane, cam, args)
        plain = cases.over_lanes(cases.plain_lane, cam, args)
        for b in range(B):
            lane = [a[b] for a in args]
            sums, inside = _f64_sums(cam, *lane)
            Jin = lane[5][inside].double()
            share = (Jin * Jin).sum(-1).median() / (Jin * Jin).sum()
            assert inside.sum() > 1000 and share > 10 * F64_TOL
            for k, (x, s, p) in enumerate(zip(kernel, sums, plain)):
                assert _rel(x[b], s) < F64_TOL, (b, k)
                assert _rel(x[b], p[b]) < PLAIN_TOL, (b, k)
            if B > 1:  # the batched call is each lane's own call
                assert _equal([x[b] for x in kernel],
                              cases.kernel_lane(cam, *lane))


@pytest.mark.cuda
@pytest.mark.parametrize("dims", VMAP_DIMS)
def test_vmap_over_kernel_equals_per_lane_calls(cuda_device, dims):
    # the vmap rule on the card: one launch for the three lanes, each lane
    # bit-equal to its own one-lane call; "pose_unmapped" hands the
    # kernel R and t at lane stride 0, "cloud_at_1" folds a cloud mapped
    # at axis 1 (copied to contiguous lanes)
    level = _cloud_levels(cuda_device)[1]
    cam = level[0]
    in_dims, args, lanes = _three_lanes(level, dims)
    before = dense_ic.ic_pass.launches
    out = torch.func.vmap(lambda *a: _op(cam, *a), in_dims=in_dims)(*args)
    assert dense_ic.ic_pass.launches == before + 1
    for k, lane in enumerate(lanes):
        own = _op(cam, *lane)
        assert _equal([x[k] for x in out], own)
        sums, _ = _f64_sums(cam, *lane)
        for x, ref in zip(own, sums):
            assert _rel(x, ref) < F64_TOL


@pytest.mark.cuda
def test_kernel_edge_cases(cuda_device):
    args, mask = _edge_cloud(cuda_device)
    sums, inside = _f64_sums(EDGE_CAM, *args)
    assert torch.equal(inside, mask)
    got = tdt._ic_pass(EDGE_CAM, *args)
    for a, b in zip(got, sums):
        np.testing.assert_allclose(a.double().cpu(), b.cpu(), rtol=1e-6,
                                   atol=1e-6)
    assert all(torch.isfinite(x).all() for x in got)
    # every point out of frame or invalid: exact zeros, as the plain
    # version gives
    for valid in (torch.zeros_like(args[-1]), args[-1] & ~mask):
        out = tdt._ic_pass(EDGE_CAM, *args[:-1], valid)
        assert all(not x.any() for x in out)
    # an empty cloud
    img, R, t, c, i, J, v = args
    empty = tdt._ic_pass(EDGE_CAM, img, R, t, c[:0], i[:0], J[:0], v[:0])
    assert all(not x.any() for x in empty)


@pytest.mark.cuda
def test_graph_replays_are_bit_equal_and_counted(cuda_device, cell_levels):
    # one level's 31 evaluations over 8 lanes captured as a CUDA graph:
    # two replays bit-equal to each other and to the eager calls, the 31
    # calls noted in stereo_bm.CAPTURED at the capture, one launch counted
    # per eager call
    cam, img, c, i, J, v = cell_levels["fleet"][0]
    R = torch.eye(3, device=cuda_device).repeat(img.shape[0], 1, 1)
    t = torch.zeros(img.shape[0], 3, device=cuda_device)
    args = (img, R, t, c, i, J, v)

    def calls():
        return [cases.over_lanes(cases.kernel_lane, cam, args)
                for _ in range(31)]

    before = dense_ic.ic_pass.launches
    eager = cases.over_lanes(cases.kernel_lane, cam, args)
    assert dense_ic.ic_pass.launches == before + 1
    recorded = []
    graph, outs = cases.graph_of(calls, recorded)
    assert len(recorded) == 31 and set(recorded) == {dense_ic.ic_pass}
    graph.replay()
    first = [[x.clone() for x in o] for o in outs]
    graph.replay()
    torch.cuda.synchronize()
    for o1, o2 in zip(first, outs):
        assert _equal(o1, o2) and _equal(o1, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["nc", "fleet"])
def test_lm_level_ic_with_kernel_within_correct_bars(cuda_device,
                                                     cell_levels, cell):
    # each level's LM from the identity, with the kernel and with the
    # plain version: the pose within correct's median bar, chi2 within
    # 1e-4 relative
    for level in range(3):
        cam, img, c, i, J, v = cell_levels[cell][level]
        R0 = torch.eye(3, device=cuda_device)
        t0 = torch.zeros(3, device=cuda_device)
        outs = []
        for fn in (tdt._ic_pass, cases.plain_lane):
            saved = tdt._ic_pass
            tdt._ic_pass = fn
            try:
                if img.shape[0] == 1:  # nc: the frame step's own call
                    outs.append(tdt._lm_level_ic(cam, img[0], c[0], i[0],
                                                 J[0], v[0], R0, t0))
                else:  # fleet: lanes of the pool's vmapped program
                    with tdt.lanes():
                        outs.append(torch.func.vmap(
                            lambda *a: tdt._lm_level_ic(cam, *a, R0, t0))(
                            img, c, i, J, v))
            finally:
                tdt._ic_pass = saved
        (Rk, tk, ck, _), (Rp, tp, cp, _) = outs
        assert float((Rk - Rp).abs().max()) < POSE_TOL
        assert float((tk - tp).abs().max()) < POSE_TOL
        assert _rel(ck, cp) < 1e-4


@pytest.mark.cuda
def test_step_and_tick_replays_launch_93(cuda_device):
    # 3 levels x (1 + 30 trips): a StereoFrontend's step replay and a
    # 2-stream pool's tick replay each count 93 launches
    from probes import pose_lm_probe as plp
    from scavislam_tpu_torch.models.frontend import StereoFrontend
    from scavislam_tpu_torch.parallel.stream_pool import StreamPool
    from scavislam_tpu_torch.utils.config import Config
    frames = plp.frames(5)
    fe = StereoFrontend(plp.CAM, plp.config(), device=cuda_device)
    fe.process_first_frame(frames[0])  # the capture
    for f in frames[1:]:
        before = dense_ic.ic_pass.launches
        assert fe.process_frame(f)[0]
        assert dense_ic.ic_pass.launches - before == 93
    assert (fe._step.captures, fe._step.replays) == (1, len(frames) - 1)
    seqs = [SyntheticSequence(CAM, n_frames=4, device=cuda_device)
            for _ in range(2)]
    ticks = [[{"frame_id": k, "left": f["left"], "right": f["right"]}
              for f in (q.frame(k) for q in seqs)] for k in range(4)]
    pool = StreamPool(CAM, Config(), n_streams=2, device=cuda_device)
    pool.process_first_frames(ticks[0])  # the capture
    for tick in ticks[1:]:
        before = dense_ic.ic_pass.launches
        pool.process_frames(tick)
        assert dense_ic.ic_pass.launches - before == 93
    pool.finish()
    (graph,) = pool.step.graphs
    assert (graph.captures, graph.replays) == (1, len(ticks) - 1)

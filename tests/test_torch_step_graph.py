"""The stereo frame step as a device program, on the CPU: the fixed-trip
dense LM against the twin's while_loop (JAX, jit on the CPU) and against
the same body run one trip at a time; the early exit the CPU takes, bit
for bit the loop run to its last trip; the frame step with every host
read of a tensor made to raise; ``StepGraph``'s input reuse.

The CUDA graph itself needs a card: tests/test_torch_cuda.py replays it
there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scavislam_tpu.core.camera import StereoCamera as JCam
from scavislam_tpu.io import synthetic as jsyn
from scavislam_tpu.models import dense_tracker as jdt
from scavislam_tpu.ops import image as jimg
from scavislam_tpu_torch.core.camera import StereoCamera as TCam
from scavislam_tpu_torch.core.lie import SE3
from scavislam_tpu_torch.models import dense_tracker as tdt
from scavislam_tpu_torch.models import frontend_step as tfs
from scavislam_tpu_torch.models import pose_optimizer as tpo
from scavislam_tpu_torch.models.frontend import StereoFrontend
from scavislam_tpu_torch.models.step_graph import (
    GraphedFn,
    MonoStepGraph,
    StepGraph,
    _Captured,
)
from scavislam_tpu_torch.utils.config import Config

# the 256x192 camera the JAX VO tests use
J_CAM = JCam.create(195.0, (127.0, 95.0), (256, 192), 0.12)
T_CAM = TCam.create(195.0, (127.0, 95.0), (256, 192), 0.12)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (the port's many small eager ops oversubscribe
    a machine shared by one test process per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def clouds():
    """Frame 0's per-level clouds and template Jacobians (the frame step's
    dense state), frames 0 and 1's pyramids, on both sides."""
    seq = jsyn.SyntheticSequence(J_CAM, n_frames=2)
    fr = [{k: np.asarray(seq.frame(i)[k]) for k in ("left", "disp_gt")}
          for i in range(2)]
    cams_t = [T_CAM.scale_level(l) for l in range(3)]
    cam_params = tuple((c.focal, c.pp[0], c.pp[1], c.baseline)
                       for c in cams_t)
    pyr = [jimg.build_pyramid(jnp.asarray(f["left"]), 3) for f in fr]
    dxs, dys = zip(*[jimg.sobel_xy(p) for p in pyr[0]])
    state = tfs._cloud_state(
        tuple(_t(p) for p in pyr[0]), _t(fr[0]["disp_gt"]), torch.eye(3),
        torch.zeros(3), cam_params, 3, tuple(_t(d) for d in dxs),
        tuple(_t(d) for d in dys))
    return {"pyr": pyr, "state": state}


def _while_lm_ic(cam, img, c, i, J, v, R, t, max_iters):
    """The twin's while_loop (cond, then body) run one body at a time on
    the port's own operations, f32 tensors throughout. Returns (R, t, chi2,
    iters, why it stopped)."""
    H, b, chi2 = tdt._ic_pass(cam, img, R, t, c, i, J, v)
    mu = torch.tensor(0.01)
    nu = torch.tensor(2.0)
    trial = it = 0
    eye = torch.eye(6)
    while True:
        if it >= max_iters:
            return R, t, chi2, it, "max_iters"
        Hd = H + mu * torch.diag(torch.diag(H)) + 1e-12 * eye
        L, info = torch.linalg.cholesky_ex(Hd)
        d = torch.cholesky_solve(-b[:, None], L)[:, 0]
        d = torch.where(torch.isfinite(d) & (info == 0), d, 0.0)
        Te = SE3.exp(-d)
        R_new, t_new = R @ Te.R, R @ Te.t + t
        H_new, b_new, chi2_new = tdt._ic_pass(cam, img, R_new, t_new, c, i,
                                              J, v)
        rho = chi2 - chi2_new
        if rho > 0:
            mu = mu * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
            nu = torch.tensor(2.0)
            R, t, H, b, chi2 = R_new, t_new, H_new, b_new, chi2_new
            trial, it = 0, it + 1
            if torch.max(torch.abs(d)) <= 1e-5:
                return R, t, chi2, it, "step"
        else:
            mu, nu = mu * nu, nu * 2.0
            trial += 1
            if trial >= tdt.MAX_TRIALS:
                return R, t, chi2, it, "rejections"


def _start(seed, sigma):
    T = SE3.exp(torch.as_tensor(
        np.random.default_rng(seed).normal(0, sigma, 6).astype(np.float32)))
    return T.R, T.t


# (name, the frame tracked into, level, start (seed, sigma) or identity,
#  max_iters, how the twin's loop stops): frame 0's cloud into frame 0
# from a nearby start converges to a sub-1e-5 step; into frame 1 it ends
# on two rejections in a row; a far start exhausts max_iters = 3
PROBLEMS = [
    ("step", 0, 1, (0, 0.003), tdt.MAX_ITERS, "step"),
    ("rejections", 1, 2, None, tdt.MAX_ITERS, "rejections"),
    ("max_iters", 1, 0, (3, 0.01), 3, "max_iters"),
]


@pytest.mark.parametrize("name,frame,level,start,max_iters,why", PROBLEMS,
                         ids=[p[0] for p in PROBLEMS])
def test_lm_level_ic_matches_jax(clouds, monkeypatch, name, frame, level,
                                 start, max_iters, why):
    # The fixed-trip loop against (a) the same body run one trip at a time:
    # bit-equal, and it stops as the problem is meant to; (b) itself with
    # the CPU's early exit off: bit-equal; (c) the twin's jit on the CPU:
    # iterations equal, R and t within 1e-4, chi2 within 1e-3 relative
    # (f32 6x6 solves on normal equations summed over ~10^4 points in
    # another order). The step stop fires only on exact data, where chi2
    # ends at the f32 floor (~2e-6): there chi2 agrees within 1e-8
    # absolute; the other two end above 1e-5, where their 1e-3 relative
    # bar is the larger
    c, v, i, J = (x[level] for x in clouds["state"])
    cam = T_CAM.scale_level(level)
    img_j = clouds["pyr"][frame][level]
    img = _t(img_j)
    R0, t0 = _start(*start) if start else (torch.eye(3), torch.zeros(3))
    Rs, ts, cs, its, got = _while_lm_ic(cam, img, c, i, J, v, R0, t0,
                                        max_iters)
    assert got == why
    out = tdt._lm_level_ic(cam, img, c, i, J, v, R0, t0, max_iters=max_iters)
    for a, b in zip(out, (Rs, ts, cs, torch.tensor(its, dtype=torch.int32))):
        assert torch.equal(a, b)
    monkeypatch.setattr(tdt, "EARLY_EXIT_ON_CPU", False)
    full = tdt._lm_level_ic(cam, img, c, i, J, v, R0, t0, max_iters=max_iters)
    for a, b in zip(out, full):
        assert torch.equal(a, b)
    jc = J_CAM.scale_level(level)
    Rj, tj, chij, itj = jax.jit(
        lambda *a: jdt._lm_level_ic(jc, *a, max_iters=max_iters))(
        img_j, *(jnp.asarray(x.numpy()) for x in (c, i, J, v, R0, t0)))
    assert int(out[3]) == int(itj)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(tj), atol=1e-4)
    np.testing.assert_allclose(float(out[2]), float(chij), rtol=1e-3,
                               atol=1e-8)
    assert (float(out[2]) < 1e-5) == (why == "step")


def test_motion_only_early_exit_bit_equal(monkeypatch):
    # the motion-only LM leaves its loop early on the CPU; run to its last
    # trip it returns the very same pose, chi2 and residuals
    rng = np.random.default_rng(7)
    n = 300
    xyz = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(2, 8, n)], -1).astype(np.float32)
    T = SE3.exp(torch.tensor([0.05, -0.02, 0.1, 0.01, -0.03, 0.02]))
    y = xyz @ T.R.numpy().T + T.t.numpy()
    f, (px, py), bl = T_CAM.focal, T_CAM.pp, T_CAM.baseline
    obs = np.stack([y[:, 0] / y[:, 2] * f + px, y[:, 1] / y[:, 2] * f + py,
                    (y[:, 0] - bl) / y[:, 2] * f + px], -1)
    obs = (obs + rng.normal(0, 0.3, obs.shape)).astype(np.float32)
    obs[::10] += rng.uniform(-20, 20, obs[::10].shape).astype(np.float32)
    args = (T_CAM, SE3(torch.eye(3), torch.zeros(3)), _t(xyz), _t(obs),
            _t((0.25 ** rng.integers(0, 3, n)).astype(np.float32)),
            _t(rng.uniform(size=n) > 0.05))
    early = tpo.motion_only_ba(*args)
    monkeypatch.setattr(tdt, "EARLY_EXIT_ON_CPU", False)
    full = tpo.motion_only_ba(*args)
    for a, b in ((early.T.R, full.T.R), (early.T.t, full.T.t),
                 (early.chi2, full.chi2), (early.residuals, full.residuals)):
        assert torch.equal(a, b)


_HOST_READS = ("item", "tolist", "numpy", "__bool__", "__int__",
               "__float__", "__index__")


@pytest.mark.parametrize("method", [1, 2])
def test_frontend_step_makes_no_host_read(monkeypatch, method):
    # one frame step (the third frame, with the first keyframe's points in
    # the tables) with every way of reading a tensor on the host made to
    # raise, the early exit off: the step runs through, as it must to be
    # captured into a CUDA graph, and its packed vector equals the step's
    # with the early exit on
    cfg = Config()
    cfg = dataclasses.replace(cfg, ui=dataclasses.replace(
        cfg.ui, stereo_method=method))
    seq = jsyn.SyntheticSequence(J_CAM, n_frames=3)
    frames = [{"frame_id": k, "left": np.asarray(seq.frame(k)["left"]),
               "right": np.asarray(seq.frame(k)["right"])} for k in range(3)]
    fe = StereoFrontend(T_CAM, cfg, device="cpu")
    fe.process_first_frame(frames[0])
    assert fe.process_frame(frames[1])[0]
    calls = []

    def guarded(*args, **kwargs):
        def refuse(*_, **__):
            raise AssertionError("the frame step read a tensor on the host")
        with monkeypatch.context() as m:
            m.setattr(tdt, "EARLY_EXIT_ON_CPU", False)
            for name in _HOST_READS:
                m.setattr(torch.Tensor, name, refuse)
            out = tfs.frontend_step(*args, **kwargs)
        calls.append(tfs.frontend_step(*args, **kwargs))
        return out

    fe._step = guarded
    cand = fe._collect_candidates()
    out = fe._run_step(frames[2], cand)
    assert len(calls) == 1
    assert torch.equal(out.packed, calls[0].packed)
    assert float(out.packed[25]) >= 20  # the frame tracks


def test_step_graph_reuses_unchanged_inputs():
    # a static input is copied again unless it is the very tensor copied
    # last time at the same version: a replaced table and one written in
    # place are copied, an untouched one is not
    a, b = torch.zeros(3), torch.zeros(3)
    cap = _Captured(None, [torch.empty(3), torch.empty(3)], None, [])
    cap.load([a, b])
    assert torch.equal(cap.static_in[0], a)
    cap.static_in[0].fill_(7.0)  # marks the buffer: a reload overwrites it
    cap.load([a, b])
    assert float(cap.static_in[0][0]) == 7.0  # a untouched: not copied
    a.add_(1.0)
    c = torch.full((3,), 5.0)
    cap.load([a, c])
    assert torch.equal(cap.static_in[0], a)  # written in place: copied
    assert torch.equal(cap.static_in[1], c)  # replaced: copied


@pytest.mark.parametrize("actkey", [torch.zeros((), dtype=torch.int32), 0],
                         ids=["cpu_tensor", "host_int"])
def test_step_graph_refuses_cpu_tensors_and_host_actkey(actkey):
    # a CUDA graph exists only on a card: CPU tensors raise, never run; a
    # host int for the active keyframe would be a static argument (one
    # graph per keyframe) and raises too
    def never(*_):
        raise AssertionError("ran")

    with pytest.raises(TypeError):
        StepGraph()(torch.zeros(2, 4, 4, dtype=torch.uint8), (), (), (), (),
                    torch.eye(3), torch.zeros(3), actkey, (), (),
                    torch.zeros(4, dtype=torch.int32), (), ())
    with pytest.raises(TypeError):
        GraphedFn(never)(torch.zeros(3), 1.0)


@pytest.mark.parametrize("actkey", [torch.zeros((), dtype=torch.int64), 0],
                         ids=["cpu_tensor", "host_int"])
def test_mono_step_graph_refuses_cpu_tensors_and_host_actkey(actkey):
    # as StepGraph: CPU tensors raise, never run; a host int for the
    # active keyframe (the mono step's argument 3) raises too
    with pytest.raises(TypeError):
        MonoStepGraph()(torch.zeros(4, 4, dtype=torch.uint8), torch.eye(3),
                        torch.zeros(3), actkey, (), (), torch.zeros(1, 3, 3),
                        torch.zeros(4, dtype=torch.int32))


def test_capture_records_launches_per_thread():
    # a counted wrapper called while its thread captures a graph notes the
    # call (the replays count it); another thread's calls meanwhile count
    # at once
    import threading

    from scavislam_tpu_torch.ops import stereo_bm
    fn = stereo_bm.block_matching_disparity_bm
    n = fn.launches
    stereo_bm.CAPTURED.calls = recorded = []
    try:
        stereo_bm._count(fn)
        other = threading.Thread(target=stereo_bm._count, args=(fn,))
        other.start()
        other.join(timeout=10)
        assert not other.is_alive()
    finally:
        stereo_bm.CAPTURED.calls = None
    assert recorded == [fn]
    assert fn.launches == n + 1
    stereo_bm._count(fn)
    assert fn.launches == n + 2


def test_collector_off_while_any_capture_runs():
    # Python's cyclic collector is off while at least one capture runs
    # (nested here, as two threads' captures overlap) and back as it was
    # once the last one ends
    import gc

    from scavislam_tpu_torch.models.step_graph import _CollectorOff
    off = _CollectorOff()
    was = gc.isenabled()
    gc.enable()
    try:
        with off:
            assert not gc.isenabled()
            with off:
                assert not gc.isenabled()
            assert not gc.isenabled()
        assert gc.isenabled()
        gc.disable()
        with off:
            assert not gc.isenabled()
        assert not gc.isenabled()  # off before, left off
    finally:
        (gc.enable if was else gc.disable)()

"""The batched multistream steps (scavislam_tpu_torch.parallel.multistream)
against the JAX package on the CPU.

- ``tracking_core`` against ``jax.vmap`` of the twin's ``_tracking_core``
  (``sp_axis=None``) on the problem of ``tests/test_parallel.py``;
- the batched frontend step's twin route (stereo method 1 per stream, the
  JAX package's CPU path) against JAX ``frontend_step`` per stream from the
  same state, at the batched density and the exact sampler;
- its kernel route (the batched block-matching kernel's plain version on
  the CPU) against the port's own single-stream method-2 step: the two
  stereo semantics agree only statistically (tests/test_ops_stereo.py), so
  each route is held against its own kind.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scavislam_tpu.core.camera import StereoCamera as JCam
from scavislam_tpu.core.lie import SE3 as JSE3
from scavislam_tpu.io.synthetic import SyntheticSequence, default_room, varied_box
from scavislam_tpu.models.frontend import StereoFrontend as JFrontend
from scavislam_tpu.models.frontend_step import DENSE_SUBS_BATCHED as J_SUBS_B
from scavislam_tpu.parallel.multistream import _tracking_core
from scavislam_tpu.utils.config import Config as JConfig
from scavislam_tpu_torch import interop
from scavislam_tpu_torch.core.lie import SE3
from scavislam_tpu_torch.models.frontend import _to_u8
from scavislam_tpu_torch.models.frontend_step import (
    DENSE_SUBS_BATCHED,
    frontend_step,
)
from scavislam_tpu_torch.ops import stereo_bm
from scavislam_tpu_torch.parallel.multistream import (
    build_multistream_frontend,
    build_multistream_step,
    stack_streams,
    tracking_core,
)
from scavislam_tpu_torch.parallel.stream_pool import StreamPool

J_CAM = JCam.create(195.0, (127.0, 95.0), (256, 192), 0.12)
T_CAM = interop.camera(np.asarray(J_CAM.focal), np.asarray(J_CAM.pp),
                       J_CAM.size, np.asarray(J_CAM.baseline))
CAM_PARAMS = (195.0, 127.0, 95.0, 0.12)
B = 2
CPU = torch.device("cpu")


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


def _problem(B=4, N=256, seed=0):
    """tests/test_parallel.py's make_problem, as numpy arrays."""
    key = jax.random.PRNGKey(seed)
    ks = jax.random.split(key, 4)
    xyz = jnp.stack(
        [jax.random.normal(ks[0], (B, N)) * 1.5,
         jax.random.normal(ks[1], (B, N)) * 1.0,
         jax.random.uniform(ks[2], (B, N)) * 5 + 3], axis=-1)
    T_gt = [JSE3.exp(jax.random.normal(jax.random.fold_in(key, i), (6,)) * 0.1)
            for i in range(B)]
    obs = jnp.stack([J_CAM.map_uvu(T.apply(xyz[i])) for i, T in enumerate(T_gt)])
    n = np.array  # writable copies
    return dict(
        R=np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)).copy(),
        t=np.zeros((B, 3), np.float32), xyz=n(xyz), obs=n(obs),
        w=np.ones((B, N), np.float32), v=np.ones((B, N), bool),
        T_gt=[(n(T.R), n(T.t)) for T in T_gt])


def test_tracking_core_matches_jax_and_recovers_poses():
    # the twin's core, vmapped over 4 streams of 256 points, 10 iterations:
    # R, t within 1e-5 (f32 normal equations summed in another order),
    # chi2 within 1e-5; and the poses are the ground truth within 1e-3
    p = _problem()
    iters = 10
    Rj, tj, cj = jax.vmap(
        lambda R, t, x, o, w, v: _tracking_core(CAM_PARAMS, R, t, x, o, w, v,
                                                iters, sp_axis=None)
    )(*(jnp.asarray(p[k]) for k in ("R", "t", "xyz", "obs", "w", "v")))
    Rt, tt, ct = tracking_core(
        CAM_PARAMS, *(torch.as_tensor(p[k]) for k in
                      ("R", "t", "xyz", "obs", "w", "v")), iters=iters)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5)
    for i, (Rg, tg) in enumerate(p["T_gt"]):
        T = SE3(Rt[i], tt[i]) @ SE3(torch.as_tensor(Rg),
                                    torch.as_tensor(tg)).inverse()
        assert float(torch.max(torch.abs(T.log()))) < 1e-3, i
    # the builder is the same core
    step = build_multistream_step(None, CAM_PARAMS, iters=iters)
    Rs, ts, _ = step(*(torch.as_tensor(p[k]) for k in
                       ("R", "t", "xyz", "obs", "w", "v")))
    assert torch.equal(Rs, Rt) and torch.equal(ts, tt)


def _cfg(method):
    cfg = JConfig()
    return dataclasses.replace(cfg, ui=dataclasses.replace(cfg.ui, stereo_method=method))


@pytest.fixture(scope="module")
def batch():
    """Two streams (default_room, varied_box(1)) after their first frame in
    the JAX frontend at the batched density, stereo method 1; per stream the
    state as numpy and JAX's own step on frame 1 from it (exact sampler)."""
    streams = []
    for planes in (default_room(), varied_box(1)):
        seq = SyntheticSequence(J_CAM, n_frames=2, planes=planes)
        f0, f1 = (seq.frame(i) for i in range(2))
        host = lambda f, i: {"frame_id": i, "left": np.array(f["left"]),  # noqa: E731
                             "right": np.array(f["right"])}
        fe = JFrontend(J_CAM, _cfg(1))
        fe.dense_subs = J_SUBS_B
        fe.process_first_frame(host(f0, 0))
        cand = fe._collect_candidates()
        n = np.asarray
        st = dict(
            poses=[n(fe.poses.R), n(fe.poses.t), n(fe.poses.valid)],
            points=[n(x) for x in fe.points],
            dense=[[n(x) for x in fe._prev_clouds],
                   [n(x) for x in fe._prev_intens],
                   [n(x) for x in fe._prev_valids], [n(x) for x in fe._prev_J]],
            R=n(fe._dev_R_cw), t=n(fe._dev_t_cw), ak=fe.actkey_id, cand=cand,
            frame=np.stack([_to_u8(np.array(f1["left"])),
                            _to_u8(np.array(f1["right"]))]))
        st["packed"] = n(fe._run_step(host(f1, 1), cand).packed)
        streams.append(st)
    # the port's batched inputs
    tb = dict(
        frames=torch.as_tensor(np.stack([s["frame"] for s in streams])),
        dense=stack_streams([interop.dense_state(*s["dense"]) for s in streams]),
        R=torch.as_tensor(np.stack([s["R"] for s in streams])),
        t=torch.as_tensor(np.stack([s["t"] for s in streams])),
        ak=[s["ak"] for s in streams],
        poses=stack_streams([interop.pose_table(*s["poses"]) for s in streams]),
        points=stack_streams([interop.point_table(*s["points"])
                              for s in streams]),
        cand=torch.as_tensor(np.stack([s["cand"] for s in streams]).astype(np.int32)),
    )
    return streams, tb


def _cams():
    cams = [T_CAM.scale_level(l) for l in range(3)]
    return (tuple((c.focal, c.pp[0], c.pp[1], c.baseline) for c in cams),
            tuple(c.size for c in cams))


def _run(tb, stereo):
    cam_params, cam_statics = _cams()
    step = build_multistream_frontend(
        None, cam_params, cam_statics, levels=3, num_disp=64,
        max_reproj=2.0, dense_subs=DENSE_SUBS_BATCHED, dense_sample="qpack",
        stereo=stereo)
    return step(tb["frames"], *tb["dense"], tb["R"], tb["t"], tb["ak"],
                tb["poses"], tb["points"], tb["cand"])


def test_twin_route_matches_jax_per_stream(batch):
    # the CPU default route: each stream's packed vector is JAX's
    # frontend_step (method 1, batched density, exact sampler) from the
    # same state. Bar: 2e-4 absolute plus 1e-6 relative. The reference
    # itself moves 8.9e-5 between two XLA optimization levels on stream 1
    # (its motion-only BA is weakly constrained in t_y there; stream 0:
    # 1.5e-5), so the bar is twice its own spread; the observations are
    # pixel coordinates of 100-250 px whose sub-pixel refinement follows the
    # dense LM's pose, summed over ~27k terms in another order. Measured:
    # within 1.1e-4 (t_y of stream 1) at this suite's XLA level.
    streams, tb = batch
    before = stereo_bm.block_matching_disparity_bm_batched.launches
    out = _run(tb, None)
    assert stereo_bm.block_matching_disparity_bm_batched.launches == before
    assert out.packed.shape == (B, streams[0]["packed"].shape[0])
    assert len(out.clouds) == 3 and out.clouds[0].shape[0] == B
    for s in range(B):
        pj = streams[s]["packed"]
        assert pj[24] > 100 and pj[25] > 100  # a real tracking problem
        np.testing.assert_allclose(out.packed[s].numpy(), pj, atol=2e-4,
                                   rtol=1e-6)


def test_kernel_route_matches_single_stream_method2(batch):
    # on the CPU the kernel route runs the batched kernel's plain version on
    # the binomial-smoothed frames; each stream is then the port's own
    # single-stream step at stereo method 2, within 1e-6
    _, tb = batch
    cam_params, cam_statics = _cams()
    out = _run(tb, "kernel")
    clouds, intens, valids, Js = tb["dense"]
    for s in range(B):
        ref = frontend_step(
            tb["frames"][s], *(tuple(x[s] for x in part) for part in
                               (clouds, intens, valids, Js)),
            tb["R"][s], tb["t"][s], tb["ak"][s],
            type(tb["poses"])(*(x[s] for x in tb["poses"])),
            type(tb["points"])(*(x[s] for x in tb["points"])),
            tb["cand"][s], cam_params, cam_statics, 3, 64, False, 2.0, 2,
            dense_subs=DENSE_SUBS_BATCHED)
        assert torch.equal(out.disp[s], ref.disp)
        np.testing.assert_allclose(out.packed[s].numpy(), ref.packed.numpy(),
                                   atol=1e-6)
        assert ref.packed[24] > 100


def test_mesh_and_bad_route_raise():
    cam_params, cam_statics = _cams()
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        build_multistream_frontend(object(), cam_params, cam_statics)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        build_multistream_step(object(), CAM_PARAMS)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        StreamPool(T_CAM, n_streams=2, mesh=object(), device=CPU)
    with pytest.raises(ValueError, match="stereo"):
        build_multistream_frontend(None, cam_params, cam_statics,
                                   stereo="bp")

"""The port's device mesh (parallel/mesh.py and the mesh paths of
parallel/multistream, models/ba_solver, models/slam_graph, models/backend
and parallel/stream_pool) on the CPU, against the JAX package on its forced
8-device CPU mesh (tests/conftest.py).

The port's mesh is a grid of explicit devices; here every member is the CPU
device, the counterpart of XLA's forced host device count: the split of the
inputs by the twin's partition specs, the shard order and the sums are
exercised, not copies between devices. Mirrors tests/test_parallel.py's
cases; what the twin marks slow is slow here too.
"""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from scavislam_tpu.models.ba_solver import solve_ba as j_solve_ba
from scavislam_tpu.parallel import multistream as jms
from scavislam_tpu_torch import interop
from scavislam_tpu_torch.core.lie import SE3
from scavislam_tpu_torch.models import backend as tbackend
from scavislam_tpu_torch.parallel.multistream import (
    build_multistream_step,
    build_sharded_ba,
    make_mesh,
    shard_stream_batch,
)

sys.path.insert(0, os.path.dirname(__file__))
from test_parallel import CAM_PARAMS, make_problem  # noqa: E402

CPU = "cpu"
KEYS = ("R", "t", "xyz", "obs", "w", "v")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n, dp=None):
    return make_mesh(n, dp=dp, devices=[CPU] * n)


def _problem(B):
    R0, t0, xyz, obs, w, v, T_gt = make_problem(B=B)
    arrays = dict(zip(KEYS, (np.array(x) for x in (R0, t0, xyz, obs, w, v))))
    return arrays, T_gt


def _port(arrays):
    return [torch.as_tensor(arrays[k]) for k in KEYS]


# -- TestMultiStream --------------------------------------------------------- #

@pytest.mark.parametrize("n,dp", [(8, None), (8, 2), (8, 1), (6, None),
                                  (3, None), (1, 1)])
def test_mesh_creation(n, dp):
    """make_mesh splits n devices as the twin's does (dp first, sp = 2 when
    n is even and dp is not given)."""
    mesh = cpu_mesh(n, dp)
    assert mesh.shape["dp"] * mesh.shape["sp"] == n
    assert mesh.shape == dict(jms.make_mesh(n, dp).shape)
    assert [str(d) for d in mesh.devices.flat] == [CPU] * n


def test_sharded_step_recovers_poses():
    mesh = cpu_mesh(8)
    step = build_multistream_step(mesh, CAM_PARAMS, iters=10)
    arrays, T_gt = _problem(mesh.shape["dp"] * 2)
    R, t, chi = step(*_port(arrays))
    assert R.shape == (8, 3, 3) and chi.shape == (8,)
    for i, T in enumerate(T_gt):
        err = (SE3(R[i], t[i]) @ SE3(torch.as_tensor(np.array(T.R)),
                                     torch.as_tensor(np.array(T.t)))
               .inverse()).log()
        assert float(torch.max(torch.abs(err))) < 1e-3, (i, err)


@pytest.mark.parametrize("dp,sp", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_matches_single_device(dp, sp):
    """The sharded step equals the unsharded one up to the summation order
    of the partials (R, t within 1e-5; the final chi2, 0.003-0.25 here,
    within 1e-3 relative, the twin's chi2 bar for the sharded BA: measured
    3e-4 at worst, a pose moved by 1e-6 on a near-converged residual), and
    the twin's sharded step on its 8-device mesh of the same shape: R, t
    within 1e-5."""
    mesh = make_mesh(dp * sp, dp=dp, devices=[CPU] * (dp * sp))
    arrays, _ = _problem(dp)
    R_sh, t_sh, c_sh = build_multistream_step(mesh, CAM_PARAMS,
                                              iters=5)(*_port(arrays))
    R_1, t_1, c_1 = build_multistream_step(None, CAM_PARAMS,
                                           iters=5)(*_port(arrays))
    np.testing.assert_allclose(R_sh.numpy(), R_1.numpy(), atol=1e-5)
    np.testing.assert_allclose(t_sh.numpy(), t_1.numpy(), atol=1e-5)
    np.testing.assert_allclose(c_sh.numpy(), c_1.numpy(), rtol=1e-3)

    jmesh = jms.make_mesh(dp * sp, dp=dp)
    R_j, t_j, _ = jms.build_multistream_step(jmesh, CAM_PARAMS, iters=5)(
        *(arrays[k] for k in KEYS))
    np.testing.assert_allclose(R_sh.numpy(), np.asarray(R_j), atol=1e-5)
    np.testing.assert_allclose(t_sh.numpy(), np.asarray(t_j), atol=1e-5)


def test_shard_stream_batch_checks_specs():
    mesh = cpu_mesh(8, dp=4)
    arrays, _ = _problem(4)
    R, xyz = shard_stream_batch(mesh, [(arrays["R"], ("dp", None, None)),
                                       (arrays["xyz"], ("dp", "sp", None))])
    assert R.shape == (4, 3, 3) and xyz.device == mesh.first
    with pytest.raises(ValueError, match="does not split over dp=4"):
        shard_stream_batch(mesh, [(np.zeros((3, 2)), ("dp",))])


# -- TestShardedBA ----------------------------------------------------------- #

@pytest.fixture(scope="module")
def entry_problem():
    """__graft_entry__'s BA problem and the twin's single-device solve."""
    import __graft_entry__ as G

    _fn, (prob,) = G.entry()
    cam_params = (389.96, 254.9, 201.9, 0.12)
    R1, t1, psi1, stats = j_solve_ba(cam_params, prob, iters=2)
    fields = {k: np.array(getattr(prob, k)) for k in prob._fields}
    return cam_params, prob, fields, (np.asarray(R1), np.asarray(t1),
                                      np.asarray(psi1),
                                      float(stats.chi2_final))


@pytest.mark.parametrize("sp", [2, 4, 8])
def test_sharded_ba_matches_single_device(entry_problem, sp):
    """build_sharded_ba over a (1, sp) mesh against the twin's
    single-device solve (the twin's tolerances: chi2 within 1e-3 relative,
    t and psi within 1e-5), and against the twin's own sharded solve on
    its 8-device mesh at sp = 8."""
    cam_params, prob, fields, (R1, t1, psi1, chi1) = entry_problem
    step = build_sharded_ba(cpu_mesh(sp, dp=1), cam_params, iters=2)
    R2, t2, psi2, chi2 = step(interop.ba_problem(**fields))
    assert abs(chi1 - float(chi2)) <= 1e-3 * max(1.0, chi1)
    np.testing.assert_allclose(t2.numpy(), t1, atol=1e-5)
    np.testing.assert_allclose(psi2.numpy(), psi1, atol=1e-5)
    np.testing.assert_allclose(R2.numpy(), R1, atol=1e-5)
    if sp == 8:
        jmesh = JMesh(np.array(jax.devices()[:8]).reshape(1, 8), ("dp", "sp"))
        rep, s_ = P(), P("sp")
        specs = dict(R=rep, t=rep, pose_valid=rep, pose_fixed=rep, psi=rep,
                     anchor_slot=rep, point_valid=rep, obs_pose=s_,
                     obs_point=s_, obs_uvu=P("sp", None), obs_weight=s_,
                     obs_valid=s_, edge_i=rep, edge_j=rep, edge_R=rep,
                     edge_t=rep, edge_info=rep, edge_valid=rep)
        prob_sh = type(prob)(**{
            k: jax.device_put(getattr(prob, k), NamedSharding(jmesh, specs[k]))
            for k in specs})
        _R, t_j, psi_j, chi_j = jms.build_sharded_ba(jmesh, cam_params,
                                                     iters=2)(prob_sh)
        np.testing.assert_allclose(t2.numpy(), np.asarray(t_j), atol=1e-5)
        np.testing.assert_allclose(psi2.numpy(), np.asarray(psi_j),
                                   atol=1e-5)
        assert abs(float(chi_j) - float(chi2)) <= 1e-3 * max(1.0, chi1)


# -- the backend's config path ----------------------------------------------- #

def test_resolve_solve_mesh_falls_back_with_warning(capsys, monkeypatch):
    """graph.solve_mesh: off at 0/1; more devices than present falls back
    to the single-device solve with the twin's warning; with enough cards
    a (1, n) mesh of the first n."""
    assert tbackend._resolve_solve_mesh(0, torch.device(CPU)) is None
    assert tbackend._resolve_solve_mesh(1, torch.device(CPU)) is None
    assert tbackend._resolve_solve_mesh(2, torch.device(CPU)) is None
    err = capsys.readouterr().err
    assert ("graph.solve_mesh=2 but only 1 device(s) present; "
            "single-device solve") in err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = tbackend._resolve_solve_mesh(4, torch.device("cuda"))
    assert mesh.shape == {"dp": 1, "sp": 4}
    assert [d.index for d in mesh.devices.flat] == [0, 1, 2, 3]


# -- the slow mirrors (slow in the twin: test_parallel.py:114, 198, 278, 338)

@pytest.mark.slow
class TestMultistreamFrontend:
    def test_sharded_full_step_matches_per_stream(self):
        """build_multistream_frontend over a dp = 2 mesh (the twin route,
        stereo method 1) against per-stream frontend_step calls on the
        twin's 64x96 camera."""
        from scavislam_tpu_torch.core.camera import StereoCamera
        from scavislam_tpu_torch.models import frontend_step as FS
        from scavislam_tpu_torch.models.map_store import PointTable, PoseTable
        from scavislam_tpu_torch.ops.image import build_pyramid, sobel_xy
        from scavislam_tpu_torch.ops.stereo import block_matching_disparity
        from scavislam_tpu_torch.parallel.multistream import (
            build_multistream_frontend,
            stack_streams,
            stream_slice,
        )

        levels, B = 3, 2
        h, w = 64, 96
        cam = StereoCamera.create(48.0, (47.5, 31.5), (w, h), 0.1)
        cams = [cam.scale_level(lv) for lv in range(levels)]
        cam_params = tuple((c.focal, c.pp[0], c.pp[1], c.baseline)
                           for c in cams)
        cam_statics = tuple(c.size for c in cams)
        rng = np.random.RandomState(0)
        frames = torch.as_tensor(rng.rand(B, 2, h, w).astype(np.float32))

        def one_state(img, right):
            pyr = build_pyramid(img, levels)
            dxs, dys = zip(*[sobel_xy(p) for p in pyr])
            disp = block_matching_disparity(img, right, num_disp=16, radius=5)
            return FS._cloud_state(pyr, disp, torch.eye(3), torch.zeros(3),
                                   cam_params, levels, dxs, dys)

        clouds, valids, intens, Js = stack_streams(
            [one_state(frames[s, 0], frames[s, 1]) for s in range(B)])
        poses = stack_streams([PoseTable.empty(device=CPU)] * B)
        points = stack_streams([PointTable.empty(device=CPU)] * B)
        cand = torch.full((B, 768), -1, dtype=torch.int32)
        R = torch.eye(3).expand(B, 3, 3)
        t = torch.zeros((B, 3))
        step = build_multistream_frontend(cpu_mesh(2, dp=2), cam_params,
                                          cam_statics, levels=levels,
                                          num_disp=16)
        out = step(frames, clouds, intens, valids, Js, R, t, [0] * B, poses,
                   points, cand)
        for s in range(B):
            ref = FS.frontend_step(
                frames[s], stream_slice(clouds, s), stream_slice(intens, s),
                stream_slice(valids, s), stream_slice(Js, s), R[s], t[s], 0,
                stream_slice(poses, s), stream_slice(points, s), cand[s],
                cam_params, cam_statics, levels, 16, False, 2.0, 1)
            np.testing.assert_allclose(out.packed[s].numpy(),
                                       ref.packed.numpy(), atol=1e-4)


@pytest.mark.slow
class TestMultistreamMono:
    def test_sharded_mono_step_matches_per_stream(self):
        """build_multistream_mono over an 8-device mesh with dp = 2 against
        per-stream mono_step calls, stream state from short real mono runs
        (tests/test_parallel.py's case): each lane within `mono_bars`: 1e-5,
        or twice the single-stream step's own move under one-ulp moves of
        its state where that is larger (the vmapped program rounds
        differently, and the mono LM and depth filter amplify it)."""
        from test_torch_multistream import hold_mono, mono_bars

        from scavislam_tpu_torch.io.synthetic import SyntheticSequence
        from scavislam_tpu_torch.models.mono_frontend import MonoFrontend
        from scavislam_tpu_torch.models.mono_step import mono_step
        from scavislam_tpu_torch.parallel.multistream import (
            build_multistream_mono,
            stack_streams,
            stream_slice,
        )

        cam = interop.camera(130.0, (63.5, 47.5), (128, 96), 0.12)
        B = 2
        fes, imgs = [], []
        for s in range(B):
            seq = SyntheticSequence(cam, n_frames=3, kind="forward_arc",
                                    step=0.03 + 0.01 * s, device=CPU)
            fe = MonoFrontend(cam, device=CPU)
            fe.process_first_frame(seq.frame(0))
            ok, _ = fe.process_frame(seq.frame(1))
            assert ok
            fes.append(fe)
            imgs.append(seq.frame(2)["left"])
        cands = [torch.as_tensor(fe._collect_candidates().astype(np.int32))
                 for fe in fes]
        step = build_multistream_mono(cpu_mesh(8, dp=2), fes[0]._cam_params,
                                      fes[0]._cam_statics, levels=3)
        out = step(torch.stack(imgs),
                   torch.stack([torch.as_tensor(fe._R_cw) for fe in fes]),
                   torch.stack([torch.as_tensor(fe._t_cw) for fe in fes]),
                   torch.tensor([max(fe.actkey_id, 0) for fe in fes]),
                   stack_streams([fe.poses for fe in fes]),
                   stack_streams([fe.points for fe in fes]),
                   torch.stack([fe.Lam for fe in fes]), torch.stack(cands),
                   torch.full((B,), fes[0].conv_q_info),
                   torch.full((B,), fes[0].prior_weight))
        cams = (fes[0]._cam_params, fes[0]._cam_statics)
        for s, fe in enumerate(fes):
            args = (imgs[s], torch.as_tensor(fe._R_cw),
                    torch.as_tensor(fe._t_cw), max(fe.actkey_id, 0),
                    fe.poses, fe.points, fe.Lam, cands[s], fe.conv_q_info,
                    fe.prior_weight)
            ref = mono_step(*args, *cams, 3, 2.0, 0.18)
            hold_mono(stream_slice(out, s), ref, mono_bars(args, *cams))


@pytest.mark.slow
class TestShardedBALiveRun:
    """graph.solve_mesh in a live SlamSystem run: the trajectory within
    2e-4 of the single-device solve's (the twin's bar: the sum reassociates
    the normal-equation additions, and each solve feeds the next)."""

    def _run(self, mesh):
        from scavislam_tpu_torch.io.synthetic import SyntheticSequence
        from scavislam_tpu_torch.pipeline.slam_system import SlamSystem
        from scavislam_tpu_torch.utils.config import Config

        cam = interop.camera(195.0, (127.0, 95.0), (256, 192), 0.12)
        cfg = Config()
        cfg = dataclasses.replace(
            cfg, frontend=dataclasses.replace(cfg.frontend, covis_thr=10),
            ui=dataclasses.replace(cfg.ui, parallax_thr=0.25),
            graph=dataclasses.replace(cfg.graph, inner_window=5,
                                      outer_window=20))
        n = 30
        seq = SyntheticSequence(cam, n_frames=n, step=0.02, device=CPU)
        system = SlamSystem(cam, cfg, threaded=False,
                            enable_loop_closure=False, device=CPU)
        system.backend.graph.solve_mesh = mesh
        system.process_first_frame(seq.frame(0))
        for i in range(1, n):
            assert system.process_frame(seq.frame(i))
        system.finish()
        g = system.backend.graph
        poses = {k: (v.R.copy(), v.t.copy()) for k, v in g.vertices.items()}
        traj = [(fid, np.asarray(T.t)) for fid, T in system.trajectory]
        system.shutdown()
        return poses, traj, len(g.solve_log)

    def test_live_run_matches_single_device(self):
        poses1, traj1, n1 = self._run(None)
        poses8, traj8, n8 = self._run(cpu_mesh(8, dp=1))
        assert poses1.keys() == poses8.keys() and len(poses1) >= 2
        assert n1 == n8 >= 1
        for k in poses1:
            np.testing.assert_allclose(poses1[k][0], poses8[k][0], atol=2e-4)
            np.testing.assert_allclose(poses1[k][1], poses8[k][1], atol=2e-4)
        assert [f for f, _ in traj1] == [f for f, _ in traj8]
        for (_, t1), (_, t8) in zip(traj1, traj8):
            np.testing.assert_allclose(t1, t8, atol=2e-4)


@pytest.mark.slow
class TestStreamPool:
    def test_two_streams_end_to_end(self):
        """StreamPool with a dp = 2 mesh (one stream per shard), 14 ticks
        of two different scenes (tests/test_parallel.py's case)."""
        from scavislam_tpu_torch.io.synthetic import (
            SyntheticSequence,
            default_room,
            varied_box,
        )
        from scavislam_tpu_torch.parallel.stream_pool import StreamPool
        from scavislam_tpu_torch.pipeline.slam_system import ate_rmse
        from scavislam_tpu_torch.utils.config import Config

        cam = interop.camera(195.0, (127.0, 95.0), (256, 192), 0.12)
        cfg = Config()
        cfg = dataclasses.replace(
            cfg, ui=dataclasses.replace(cfg.ui, parallax_thr=0.1))
        n, B = 14, 2
        seqs = [SyntheticSequence(cam, n_frames=n, step=0.02, device=CPU,
                                  planes=default_room() if s == 0
                                  else varied_box(1)) for s in range(B)]
        gt = [[] for _ in range(B)]
        ticks = []
        for i in range(n):
            tick = []
            for s in range(B):
                f = seqs[s].frame(i)
                gt[s].append(f["T_cw_gt"])
                tick.append({"frame_id": i, "left": f["left"],
                             "right": f["right"]})
            ticks.append(tick)
        pool = StreamPool(cam, cfg, n_streams=B, mesh=cpu_mesh(2, dp=2),
                          pipeline_depth=2)
        pool.process_first_frames(ticks[0])
        for i in range(1, n):
            pool.process_frames(ticks[i])
        pool.finish()
        for s in range(B):
            assert pool.alive[s]
            traj = pool.trajectories[s]
            assert len(traj) == n
            assert pool.fes[s].next_kf >= 2
            ate = ate_rmse(traj, [gt[s][int(fid)] for fid, _ in traj])
            assert ate < 0.05, (s, ate)
        assert np.any(np.abs(pool.trajectories[0][-1][1].t
                             - pool.trajectories[1][-1][1].t) > 0)

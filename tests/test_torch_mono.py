"""The monocular mode of the port (models/mono_step, mono_frontend, mono_loop,
the uv pose optimizer and the point filter, apps/mono_vo) against the JAX
package on the CPU, and the twin's tests/test_mono.py cases mirrored on the
port.

Inputs: seeded numpy problems, and frames of the forward arc rendered once
by the JAX package's renderer at the twin's 128x96 test camera (the two
renderers agree on only part of the pixels, so both packages get the same
frames). Both frontends run synchronously, or pipelined with the JAX
frontend's fetch pool replaced by an executor that runs inline (the port's
downloads complete at once on the CPU), so both sides are deterministic.
Shared states go from the JAX frontend to the port's through
``interop.load_mono_state``.
"""

import copy
import dataclasses
import functools
import json
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scavislam_tpu.core.camera import StereoCamera as JCam
from scavislam_tpu.core.lie import SE3 as JSE3
from scavislam_tpu.io.synthetic import SyntheticSequence as JSeq
from scavislam_tpu.models import mono_step as j_mono_step
from scavislam_tpu.models import pose_optimizer as jpo
from scavislam_tpu.models.mono_frontend import MonoFrontend as JMono
from scavislam_tpu.utils.config import Config as JConfig
from scavislam_tpu_torch import interop
from scavislam_tpu_torch.core.lie import SE3, PoseRT
from scavislam_tpu_torch.models import mono_loop
from scavislam_tpu_torch.models import mono_step as t_mono_step
from scavislam_tpu_torch.models import pose_optimizer as tpo
from scavislam_tpu_torch.models.map_store import MAX_POINTS
from scavislam_tpu_torch.models.mono_frontend import MonoFrontend
from scavislam_tpu_torch.pipeline.slam_system import ate_rmse_aligned
from scavislam_tpu_torch.utils.config import Config

# the twin's test camera (tests/test_mono.py): its programs compile once
J_CAM = JCam.create(130.0, (63.5, 47.5), (128, 96), 0.12)
CAM = interop.camera(np.asarray(J_CAM.focal), np.asarray(J_CAM.pp),
                     J_CAM.size, np.asarray(J_CAM.baseline))
CAM_UV = (130.0, 63.5, 47.5)
CPU = torch.device("cpu")
N_PARITY = 12
# parallax 0.12 keyframes 4 times in the 12 parity frames (the twin's DWO
# tests' threshold), so spawns, covisibility and switches all run
PARITY_PARALLAX = 0.12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: many small eager ops per frame, one test
    process per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _InlineExecutor:
    """submit() runs the call at once and returns a completed future."""

    def submit(self, fn, *args, **kwargs):
        fut = Future()
        fut.set_result(fn(*args, **kwargs))
        return fut


@functools.lru_cache(maxsize=None)
def _render(i: int, step: float = 0.035):
    """Frame i of the forward arc at `step`, rendered by the JAX package:
    {"frame_id", "left" (f32 numpy), "T_cw_gt" (numpy PoseRT),
    "depth_gt"}."""
    f = _jseq(step).frame(i)
    return {"frame_id": i, "left": np.array(f["left"], np.float32),
            "T_cw_gt": PoseRT(np.asarray(f["T_cw_gt"].R, np.float64),
                              np.asarray(f["T_cw_gt"].t, np.float64)),
            "depth_gt": np.array(f["depth_gt"])}


@functools.lru_cache(maxsize=None)
def _jseq(step):
    return JSeq(J_CAM, n_frames=40, kind="forward_arc", step=step)


def frame(i, step=0.035):
    return dict(_render(i, step))


def _cfg(cls, parallax=None):
    cfg = cls()
    if parallax is None:
        return cfg
    return dataclasses.replace(cfg, ui=dataclasses.replace(
        cfg.ui, parallax_thr=parallax))


def _position(T):
    T = PoseRT.from_any(T)
    return -np.asarray(T.R).T @ np.asarray(T.t)


# -- the JAX run shared by the parity tests ---------------------------------- #

def _jax_snapshot(fj):
    """A JAX MonoFrontend's state: its (immutable) device tables by
    reference, its host fields copied."""
    return {
        "poses": fj.poses, "points": fj.points, "Lam": fj.Lam,
        "R_cw": fj._R_cw.copy(), "t_cw": fj._t_cw.copy(),
        "actkey_id": fj.actkey_id, "next_kf": fj.next_kf,
        "next_point": fj.next_point,
        "kf_point_ids": copy.deepcopy(fj.kf_point_ids),
        "kf_obs": copy.deepcopy(fj.kf_obs), "covis": copy.deepcopy(fj.covis),
        "pose_np": copy.deepcopy(fj.pose_np),
        "meta_anchor": fj._meta_anchor.copy(),
        "meta_level": fj._meta_level.copy(), "frame_id": fj.frame_id,
        "edge_constraints": copy.deepcopy(fj.edge_constraints),
        "kf_epoch": fj._kf_epoch, "map_gen": fj._map_gen,
        "trajectory": list(fj.trajectory),
        "last_pyr": fj.last_pyr,
    }


def _load_jax(snap, parallax=PARITY_PARALLAX):
    """A fresh JAX MonoFrontend in the snapshot's state."""
    fj = JMono(J_CAM, _cfg(JConfig, parallax))
    fj._fetch_pool = _InlineExecutor()
    fj.poses, fj.points, fj.Lam = snap["poses"], snap["points"], snap["Lam"]
    fj._R_cw, fj._t_cw = snap["R_cw"].copy(), snap["t_cw"].copy()
    fj.actkey_id = snap["actkey_id"]
    fj.next_kf, fj.next_point = snap["next_kf"], snap["next_point"]
    for k in ("kf_point_ids", "kf_obs", "covis", "pose_np",
              "edge_constraints"):
        setattr(fj, k, copy.deepcopy(snap[k]))
    fj._meta_anchor = snap["meta_anchor"].copy()
    fj._meta_level = snap["meta_level"].copy()
    fj.frame_id = snap["frame_id"]
    fj._kf_epoch, fj._map_gen = snap["kf_epoch"], snap["map_gen"]
    fj.trajectory = list(snap["trajectory"])
    return fj


def _load_port(snap, parallax=PARITY_PARALLAX):
    """A port MonoFrontend in the snapshot's state (interop)."""
    ft = MonoFrontend(CAM, _cfg(Config, parallax), device=CPU)
    p = snap["points"]
    return interop.load_mono_state(
        ft,
        poses=interop.pose_table(np.asarray(snap["poses"].R),
                                 np.asarray(snap["poses"].t),
                                 np.asarray(snap["poses"].valid)),
        points=interop.point_table(*(np.asarray(x) for x in p)),
        Lam=np.asarray(snap["Lam"]),
        **{k: snap[k] for k in (
            "R_cw", "t_cw", "actkey_id", "next_kf", "next_point",
            "kf_point_ids", "kf_obs", "covis", "pose_np", "frame_id",
            "edge_constraints", "kf_epoch", "map_gen", "trajectory")},
        meta_anchor=snap["meta_anchor"], meta_level=snap["meta_level"])


@pytest.fixture(scope="module")
def jax_run():
    """The JAX frontend synchronously over the parity frames, with
    snapshots after frame 6 and at the end."""
    fj = JMono(J_CAM, _cfg(JConfig, PARITY_PARALLAX))
    fj._fetch_pool = _InlineExecutor()
    fj.process_first_frame(frame(0))
    snaps = {}
    for i in range(1, N_PARITY):
        ok, _ = fj.process_frame(frame(i))
        assert ok, i
        if i == 6:
            snaps["mid"] = _jax_snapshot(fj)
    snaps["end"] = _jax_snapshot(fj)
    return fj, snaps


# -- module parity ------------------------------------------------------------ #

def _uv_problem(seed):
    rng = np.random.RandomState(seed)
    n = 64
    xyz = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(3, 9, n)], -1).astype(np.float32)
    xi = rng.randn(6).astype(np.float32) * 0.05
    R, t = (np.asarray(x) for x in JSE3.exp(jnp.asarray(xi)))
    y = xyz @ R.T + t
    f, px, py = CAM_UV
    obs = np.stack([y[:, 0] / y[:, 2] * f + px,
                    y[:, 1] / y[:, 2] * f + py], -1).astype(np.float32)
    obs += rng.randn(n, 2).astype(np.float32) * 0.3
    obs[:6] += rng.uniform(15, 40, (6, 2)).astype(np.float32)
    w = rng.uniform(0.05, 1.0, n).astype(np.float32)
    valid = rng.rand(n) > 0.1
    return xyz, obs, w, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_motion_only_ba_uv_matches_jax(seed):
    # the fixed-trip device loop against the twin's while_loop: the pose
    # within 1e-4, chi2 within 1e-4 relative, the inlier mask equal
    xyz, obs, w, valid = _uv_problem(seed)
    rj = jpo.motion_only_ba_uv(CAM_UV, JSE3.identity(), jnp.asarray(xyz),
                               jnp.asarray(obs), jnp.asarray(w),
                               jnp.asarray(valid))
    rt = tpo.motion_only_ba_uv(CAM_UV, SE3.identity(), torch.tensor(xyz),
                               torch.tensor(obs), torch.tensor(w),
                               torch.tensor(valid))
    np.testing.assert_allclose(rt.T.R.numpy(), np.asarray(rj.T.R), atol=1e-4)
    np.testing.assert_allclose(rt.T.t.numpy(), np.asarray(rj.T.t), atol=1e-4)
    np.testing.assert_allclose(float(rt.chi2), float(rj.chi2), rtol=1e-4)
    np.testing.assert_array_equal(rt.inlier_mask.numpy(),
                                  np.asarray(rj.inlier_mask))
    assert rt.T.R.dtype == torch.float32 and rt.chi2.dtype == torch.float32


@pytest.mark.parametrize("seed", [0, 1])
def test_filter_points_info_matches_jax(seed):
    # landmarks with known bearing and a wrong prior depth, seen with
    # parallax and pixel noise from a moved camera (the frame step's use):
    # psi and Lambda within 1e-4 relative to the largest entry
    rng = np.random.RandomState(seed)
    n = 48
    xyz = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.8, 0.8, n),
                    rng.uniform(2, 8, n)], -1)
    psi = np.stack([xyz[:, 0] / xyz[:, 2], xyz[:, 1] / xyz[:, 2],
                    np.full(n, 0.25)], -1).astype(np.float32)
    lam = np.zeros((n, 3, 3), np.float32)
    lam[:, 0, 0] = lam[:, 1, 1] = 1e4
    lam[:, 2, 2] = rng.uniform(0, 30, n)
    R = np.stack([np.asarray(JSE3.exp(jnp.asarray(
        np.r_[0, 0, 0, rng.randn(3) * 0.03], jnp.float32)).R)
        for _ in range(n)])
    t = (rng.randn(n, 3) * 0.2).astype(np.float32)
    y = np.einsum("nij,nj->ni", R, xyz) + t
    cam = (200.0, 128.0, 96.0)
    obs = np.stack([y[:, 0] / y[:, 2] * cam[0] + cam[1],
                    y[:, 1] / y[:, 2] * cam[0] + cam[2]], -1)
    obs = (obs + rng.randn(n, 2) * 0.5).astype(np.float32)
    valid = rng.rand(n) > 0.2
    fj = jpo.filter_points_info(cam, jnp.asarray(R), jnp.asarray(t),
                                jnp.asarray(psi), jnp.asarray(lam),
                                jnp.asarray(obs), jnp.asarray(valid))
    ft = tpo.filter_points_info(cam, torch.tensor(R), torch.tensor(t),
                                torch.tensor(psi), torch.tensor(lam),
                                torch.tensor(obs), torch.tensor(valid))
    for a, b in ((ft.psi, fj.psi), (ft.Lambda, fj.Lambda)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-4 * np.abs(b).max()


def test_mono_step_matches_jax(jax_run):
    # one frame step from the state after frame 6, loaded into the port:
    # gate and matched equal, the packed vector within 1e-4 (relative for
    # the chi2 and information entries), the new tables alike (each
    # point's Lambda within 1e-4 of its largest entry)
    _, snaps = jax_run
    fj = _load_jax(snaps["mid"])
    ft = _load_port(snaps["mid"])
    cand = fj._collect_candidates()
    np.testing.assert_array_equal(ft._collect_candidates(), cand)
    f7 = frame(7)
    oj = fj._run_step(f7, cand)
    ot = ft._run_step(f7, cand)
    C = 512
    pj, pt = np.asarray(oj.packed), ot.packed.numpy()
    np.testing.assert_array_equal(pt[34:34 + 2 * C], pj[34:34 + 2 * C])
    assert pj[34:34 + C].sum() >= 15  # the frame tracks
    np.testing.assert_allclose(pt, pj, rtol=1e-4, atol=1e-4)
    # each point's information within 1e-4 of its largest entry
    lj = np.asarray(oj.Lam)
    scale = np.abs(lj).max(axis=(1, 2), keepdims=True)
    assert (np.abs(ot.Lam.numpy() - lj) <= 1e-4 * scale + 1e-6).all()
    # the filtered psi table within 1e-3 relative (a few of the 5 masked
    # LM accepts per landmark differ at f32 rounding)
    np.testing.assert_allclose(ot.points.psi.numpy(),
                               np.asarray(oj.points.psi), rtol=1e-3,
                               atol=1e-5)


def test_mono_step_leaves_input_tables_alone(jax_run):
    # the functional-table rule: the step returns new tables, the caller's
    # are bitwise what they were
    _, snaps = jax_run
    ft = _load_port(snaps["mid"])
    psi0, lam0 = ft.points.psi.clone(), ft.Lam.clone()
    points, lam = ft.points, ft.Lam
    out = ft._run_step(frame(7), ft._collect_candidates())
    assert torch.equal(points.psi, psi0) and torch.equal(lam, lam0)
    assert not torch.equal(out.Lam, lam0)


def test_spawn_points_mono_matches_jax(jax_run):
    # the spawn on the JAX run's last pyramid into the mid-run tables, with
    # the end state's tracked positions as clearance: ok masks equal, psi
    # within 1e-5, the Lambda block equal
    fj, snaps = jax_run
    snap = snaps["mid"]
    pyr_j = fj.last_pyr
    rng = np.random.RandomState(0)
    uv = rng.uniform(0, 96, (512, 2)).astype(np.float32)
    tv = rng.rand(512) < 0.3
    starts = [4000, 4192, 4256]
    caps = (192, 64, 32)
    fe_params = MonoFrontend(CAM, device=CPU)._cam_params
    pts_j, lam_j, pay_j = j_mono_step.spawn_points_mono(
        pyr_j, jnp.asarray(uv), jnp.asarray(tv), snap["points"], snap["Lam"],
        jnp.asarray(starts, jnp.int32), jnp.int32(3), jnp.float32(0.25),
        fj._cam_params, fj._cam_statics, 3, caps, 2.0)
    pts_t, lam_t, pay_t = t_mono_step.spawn_points_mono(
        tuple(torch.tensor(np.asarray(p)) for p in pyr_j), torch.tensor(uv),
        torch.tensor(tv),
        interop.point_table(*(np.asarray(x) for x in snap["points"])),
        torch.tensor(np.asarray(snap["Lam"])), starts, 3, 0.25,
        fe_params, fj._cam_statics, 3, caps, 2.0)
    np.testing.assert_array_equal(pts_t.valid.numpy(),
                                  np.asarray(pts_j.valid))
    np.testing.assert_array_equal(pts_t.anchor.numpy(),
                                  np.asarray(pts_j.anchor))
    np.testing.assert_allclose(pts_t.psi.numpy(), np.asarray(pts_j.psi),
                               atol=1e-5)
    np.testing.assert_array_equal(lam_t.numpy(), np.asarray(lam_j))
    np.testing.assert_allclose(pay_t.numpy(), np.asarray(pay_j), atol=1e-4)


def _run_pair(pipelined, n=N_PARITY):
    fj = JMono(J_CAM, _cfg(JConfig, PARITY_PARALLAX))
    fj._fetch_pool = _InlineExecutor()
    ft = MonoFrontend(CAM, _cfg(Config, PARITY_PARALLAX), device=CPU)
    out = []
    for fe in (fj, ft):
        fe.process_first_frame(frame(0))
        for i in range(1, n):
            if pipelined:
                r = fe.process_frame_pipelined(frame(i))
                assert r is None or r[0], i
            else:
                ok, _ = fe.process_frame(frame(i))
                assert ok, i
        if pipelined:
            assert all(ok for ok, _, _ in fe.flush_pipeline())
        out.append(fe)
    return out


@pytest.mark.parametrize("pipelined", [False, True])
def test_mono_frontend_matches_jax(pipelined):
    # 12 frames, synchronous and pipelined at depth 2: the same frames in
    # the trajectory, camera positions within 1e-4 m, the same keyframes
    # and keyframe poses within 1e-4
    fj, ft = _run_pair(pipelined)
    assert [f for f, _ in ft.trajectory] == [f for f, _ in fj.trajectory]
    for (_, Tj), (_, Tt) in zip(fj.trajectory, ft.trajectory):
        assert np.linalg.norm(_position(Tt) - _position(Tj)) < 1e-4
    assert ft.next_kf == fj.next_kf >= 3
    assert ft.covis == {k: dict(v) for k, v in fj.covis.items()}
    for k, (R, t) in fj.pose_np.items():
        np.testing.assert_allclose(ft.pose_np[k][0], R, atol=1e-4)
        np.testing.assert_allclose(ft.pose_np[k][1], t, atol=1e-4)


@pytest.mark.parametrize("dwo", [False, True])
def test_window_ba_matches_jax(jax_run, dwo):
    # from the end state: chi2 before and after within 1e-4 relative, the
    # written-back keyframe poses within 1e-4 (relative to their size), the
    # same frozen constraints (DWO)
    _, snaps = jax_run
    fj = _load_jax(snaps["end"])
    ft = _load_port(snaps["end"])
    kw = dict(window=2, iters=3, dwo=True, outer=8) if dwo else dict(
        window=5, iters=4)
    out_j = fj.window_ba(**kw)
    out_t = ft.window_ba(**kw)
    assert out_j is not None and out_t is not None
    np.testing.assert_allclose(out_t, out_j, rtol=1e-4)
    assert out_t[1] < out_t[0]
    for k, (R, t) in fj.pose_np.items():
        np.testing.assert_allclose(ft.pose_np[k][0], R, atol=1e-4)
        np.testing.assert_allclose(ft.pose_np[k][1], t,
                                   atol=1e-4 * max(1.0, np.abs(t).max()))
    np.testing.assert_allclose(ft._t_cw, fj._t_cw, atol=1e-4)
    assert sorted(ft.edge_constraints) == sorted(fj.edge_constraints)
    if dwo:
        assert ft.edge_constraints


def test_load_mono_state_round_trip(jax_run):
    # interop carries every field: the port's candidate list, actkey and
    # counters equal the JAX frontend's
    fj, snaps = jax_run
    ft = _load_port(snaps["end"])
    np.testing.assert_array_equal(ft._collect_candidates(),
                                  fj._collect_candidates())
    assert (ft.actkey_id, ft.next_kf, ft.next_point) == (
        fj.actkey_id, fj.next_kf, fj.next_point)
    assert len(ft.trajectory) == len(fj.trajectory)
    np.testing.assert_array_equal(ft.Lam.numpy(), np.asarray(fj.Lam))


# -- the twin's tests/test_mono.py, mirrored on the port --------------------- #

def _jax_sim3_draws(n):
    """The twin's Sim3 RANSAC draw of one check, replayed: randint of a
    fresh PRNGKey(0) (mono_loop.estimate_sim3's default seed)."""
    return np.asarray(jax.random.randint(jax.random.PRNGKey(0), (256, 3), 0,
                                         n))


def run_mono(n_frames, step=0.035, **fe_kw):
    fe = MonoFrontend(CAM, device=CPU, **fe_kw)
    fe.process_first_frame(frame(0, step))
    for i in range(1, n_frames):
        ok, _ = fe.process_frame(frame(i, step))
        assert ok, f"tracking failed at frame {i}"
    gt = [frame(i, step)["T_cw_gt"] for i in range(n_frames)]
    return fe, gt


class TestMotionOnlyBaUv:
    def test_recovers_pose_from_exact_uv(self):
        rng = np.random.RandomState(0)
        n = 64
        xyz_w = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                          rng.uniform(3, 9, n)], -1).astype(np.float32)
        T_gt = SE3.exp(torch.tensor([0.08, -0.05, 0.1, 0.03, -0.04, 0.02]))
        y = xyz_w @ T_gt.R.numpy().T + T_gt.t.numpy()
        f, px, py = CAM_UV
        obs = np.stack([y[:, 0] / y[:, 2] * f + px,
                        y[:, 1] / y[:, 2] * f + py], -1).astype(np.float32)
        res = tpo.motion_only_ba_uv(
            CAM_UV, SE3.identity(), torch.tensor(xyz_w), torch.tensor(obs),
            torch.ones(n), torch.ones(n, dtype=torch.bool))
        err = (res.T @ T_gt.inverse()).log().numpy()
        assert np.abs(err).max() < 1e-4, err
        assert float(res.chi2) < 1e-6

    def test_outliers_downweighted(self):
        rng = np.random.RandomState(1)
        n = 64
        xyz_w = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                          rng.uniform(3, 9, n)], -1).astype(np.float32)
        T_gt = SE3.exp(torch.tensor([0.05, 0.02, 0.08, -0.02, 0.03, 0.01]))
        y = xyz_w @ T_gt.R.numpy().T + T_gt.t.numpy()
        f, px, py = CAM_UV
        obs = np.stack([y[:, 0] / y[:, 2] * f + px,
                        y[:, 1] / y[:, 2] * f + py], -1).astype(np.float32)
        obs[:8] += rng.uniform(15, 40, (8, 2))  # gross outliers
        res = tpo.motion_only_ba_uv(
            CAM_UV, SE3.identity(), torch.tensor(xyz_w), torch.tensor(obs),
            torch.ones(n), torch.ones(n, dtype=torch.bool))
        err = (res.T @ T_gt.inverse()).log().numpy()
        assert np.abs(err).max() < 2e-2, err


class TestMonoVo:
    def test_tracks_up_to_scale_and_depths_converge(self):
        n = 16
        fe, gt = run_mono(n)
        ate = ate_rmse_aligned(fe.trajectory, gt)
        path_len = sum(float(np.linalg.norm(_position(b) - _position(a)))
                       for a, b in zip(gt[:-1], gt[1:]))
        assert ate < 0.06 * path_len, (ate, path_len)

        ids = fe.kf_point_ids[0]
        psi = fe.points.psi.numpy()[ids]
        lam_qq = fe.Lam.numpy()[ids, 2, 2]
        conv = lam_qq > fe.conv_q_info
        assert conv.sum() >= 30, f"only {conv.sum()} points converged"
        depth0 = frame(0)["depth_gt"]
        uv0 = fe.points.uv0.numpy()[ids]  # level-0 coordinates
        u_l0 = np.clip(uv0[:, 0].round().astype(int), 0, depth0.shape[1] - 1)
        v_l0 = np.clip(uv0[:, 1].round().astype(int), 0, depth0.shape[0] - 1)
        z_gt = depth0[v_l0, u_l0]
        z_est = 1.0 / np.maximum(psi[:, 2], 1e-6)
        sel = conv & (z_gt > 0.5)
        ratio = z_est[sel] / z_gt[sel]
        med = np.median(ratio)
        frac_close = (np.abs(ratio / med - 1.0) < 0.15).mean()
        assert frac_close > 0.85, (med, frac_close)

    def test_pure_prior_scale_gauge(self):
        n = 8
        fe_a, gt = run_mono(n, prior_idepth=0.25)
        fe_b, _ = run_mono(n, prior_idepth=0.125)
        na = np.linalg.norm(fe_a.trajectory[-1][1].t)
        nb = np.linalg.norm(fe_b.trajectory[-1][1].t)
        assert 1.6 < nb / na < 2.4, (na, nb)
        assert ate_rmse_aligned(fe_b.trajectory, gt) < 0.05

    @pytest.mark.slow
    def test_loop_closure_sim3(self):
        n = 14
        fe = MonoFrontend(CAM, device=CPU)
        fe.process_first_frame(frame(0))
        for i in range(1, 8):
            ok, dropped = fe.process_frame(frame(i))
            assert ok and not dropped
        # force-spawn keyframe 1 at the current pose WITHOUT clearance: its
        # points land on the corners keyframe 0's did
        kf1 = fe._new_keyframe_id()
        fe.poses = fe.poses.set(kf1, SE3(torch.tensor(fe._R_cw),
                                         torch.tensor(fe._t_cw)))
        fe.pose_np[kf1] = (fe._R_cw.copy(), fe._t_cw.copy())
        fe.covis[kf1] = {0: 100}
        fe.covis[0][kf1] = 100
        fe._spawn(fe.last_pyr, kf1, None)
        fe.actkey_id = kf1
        for i in range(8, n):
            ok, _ = fe.process_frame(frame(i))
            assert ok

        # (a0) automatic detection: retrieval + Sim3 verification
        pr = mono_loop.make_mono_place_recognizer(fe, score_thr=0.05,
                                                  min_inliers=10)
        pr.hypotheses = _jax_sim3_draws
        assert pr.add_location({"kf_id": 0, "img": frame(0)["left"],
                                "disp": None, "exclude": {0}}) is None
        det = pr.add_location({"kf_id": kf1, "img": frame(7)["left"],
                               "disp": None, "exclude": {kf1}})
        assert det is not None and det.loop_id == 0, det
        assert abs(float(det.S_query_from_loop.s) - 1.0) < 0.08

        # (a) consistent maps: Sim3 at s ~ 1, relative pose ~ the VO's
        S, n_inl = mono_loop.estimate_sim3(fe, kf1, 0, min_inliers=10,
                                           hypotheses=_jax_sim3_draws)
        assert S is not None and n_inl >= 10, n_inl
        assert abs(float(S.s) - 1.0) < 0.08, float(S.s)
        R0, t0 = fe.pose_np[0]
        R1, t1 = fe.pose_np[kf1]
        R_rel = R1 @ R0.T
        t_rel = t1 - R_rel @ t0
        np.testing.assert_allclose(S.R.numpy(), R_rel, atol=0.03)
        np.testing.assert_allclose(S.t.numpy(), t_rel, atol=0.08)

        # (b) a scale drift injected on kf1's map and pose is detected
        drift = 1.3
        s_pp = np.ones(MAX_POINTS, np.float32)
        s_pp[fe._meta_anchor == kf1] = 1.0 / drift
        fe.points = fe.points._replace(
            psi=mono_loop._regauge_psi(fe.points.psi, torch.tensor(s_pp)))
        t1_d = (t1 * drift).astype(np.float32)
        fe.pose_np[kf1] = (R1, t1_d)
        fe.poses = fe.poses.set(kf1, SE3(torch.tensor(R1), torch.tensor(t1_d)))
        fe._t_cw = (fe._t_cw * drift).astype(np.float32)
        S_d, n_inl_d = mono_loop.estimate_sim3(fe, kf1, 0, min_inliers=10,
                                           hypotheses=_jax_sim3_draws)
        assert S_d is not None, n_inl_d
        assert abs(float(S_d.s) - drift) < 0.12 * drift, float(S_d.s)

        # (c) closing the loop redistributes the drift and re-gauges
        def kf1_dist_from_kf0():
            R0_, t0_ = fe.pose_np[0]
            R1_, t1_ = fe.pose_np[kf1]
            return float(np.linalg.norm(-R1_.T @ t1_ - (-R0_.T @ t0_)))

        d_true = float(np.linalg.norm(-R1.T @ t1 - (-R0.T @ t0)))
        d_drifted = kf1_dist_from_kf0()
        assert d_drifted > d_true * 1.2
        ids1, v1 = mono_loop._kf_points_padded(fe, kf1)
        probe = int(ids1[v1][0])
        q_before = float(fe.points.psi[probe, 2])
        scales = mono_loop.close_loop_sim3(fe, kf1, 0, S_d)
        assert scales[kf1] > 1.05, scales
        d_after = kf1_dist_from_kf0()
        assert d_after < d_drifted - 0.3 * (d_drifted - d_true), (
            d_true, d_drifted, d_after)
        q_after = float(fe.points.psi[probe, 2])
        np.testing.assert_allclose(q_after / q_before, scales[kf1],
                                   rtol=1e-5)
        assert np.isfinite(fe._t_cw).all() and np.isfinite(fe._R_cw).all()

    def test_window_ba_refines(self):
        n = 16
        fe, _ = run_mono(n, cfg=_cfg(Config, 0.3))
        assert fe.next_kf >= 2
        kf_ids = sorted(fe.pose_np.keys())[-5:]
        k_last = kf_ids[-1]
        R_l, t_l = fe.pose_np[k_last]
        t_bad = t_l + np.array([0.03, -0.02, 0.04], np.float32)
        fe.pose_np[k_last] = (R_l, t_bad)
        fe.poses = fe.poses.set(k_last, SE3(torch.tensor(R_l),
                                            torch.tensor(t_bad)))
        gauge_before = tuple(map(np.copy, fe.pose_np[kf_ids[0]]))
        out = fe.window_ba(window=5, iters=4)
        assert out is not None
        chi2_0, chi2_1 = out
        assert chi2_1 < chi2_0 * 0.5, (chi2_0, chi2_1)
        np.testing.assert_array_equal(fe.pose_np[kf_ids[0]][0],
                                      gauge_before[0])
        np.testing.assert_array_equal(fe.pose_np[kf_ids[0]][1],
                                      gauge_before[1])
        t_opt = fe.pose_np[k_last][1]
        assert (np.linalg.norm(t_opt - t_l)
                < 0.5 * np.linalg.norm(t_bad - t_l)), (t_l, t_bad, t_opt)

    def test_window_ba_async_matches_sync(self):
        fe_s, _ = run_mono(14, cfg=_cfg(Config, 0.3))
        fe_a, _ = run_mono(14, cfg=_cfg(Config, 0.3))
        assert fe_s.next_kf >= 2
        out_s = fe_s.window_ba(window=5, iters=3)
        assert out_s is not None
        assert fe_a.window_ba(window=5, iters=3, sync=False) == "dispatched"
        assert fe_a.adopt_pending_ba(force=True)
        assert fe_a.last_ba_chi2 == out_s
        for k in fe_s.pose_np:
            np.testing.assert_array_equal(fe_a.pose_np[k][0],
                                          fe_s.pose_np[k][0])
            np.testing.assert_array_equal(fe_a.pose_np[k][1],
                                          fe_s.pose_np[k][1])
        assert torch.equal(fe_a.points.psi, fe_s.points.psi)

        # a re-gauge between dispatch and adoption discards the solve
        psi_before = fe_a.points.psi.clone()
        assert fe_a.window_ba(window=5, iters=3, sync=False) == "dispatched"
        fe_a._map_gen += 1  # what close_loop_sim3 / relocalize do
        assert not fe_a.adopt_pending_ba(force=True)
        assert torch.equal(fe_a.points.psi, psi_before)

    def test_async_ba_corrects_inflight_frames(self):
        n = 19
        fe = MonoFrontend(CAM, _cfg(Config, 0.3), device=CPU)
        fe.process_first_frame(frame(0))
        for i in range(1, 13):
            r = fe.process_frame_pipelined(frame(i))
            assert r is None or r[0]
        assert fe.next_kf >= 2, "needs a keyframe for a window"

        # (a) a forced adoption with frames in flight attaches the actkey
        # correction to every pending entry
        assert fe.window_ba(window=5, iters=4, sync=False) == "dispatched"
        assert len(fe._pending) > 0
        assert fe.adopt_pending_ba(force=True)
        assert all(e[5] is not None for e in fe._pending)

        # (b) the next consume applies T_cw' = T_cw_packet @ corr
        entry = fe._pending[0]
        pk = entry[3].result()
        R_pkt = pk[0:9].reshape(3, 3)
        t_pkt = pk[9:12]
        R_c, t_c = entry[5]
        r = fe.process_frame_pipelined(frame(13))
        assert r is not None and r[0]
        np.testing.assert_allclose(fe._R_cw, R_pkt @ R_c, atol=1e-6)
        np.testing.assert_allclose(fe._t_cw, R_pkt @ t_c + t_pkt, atol=1e-6)

        for i in range(14, n):
            r = fe.process_frame_pipelined(frame(i))
            assert r is None or r[0], f"lost at {i}"
        for ok, _d, _f in fe.flush_pipeline():
            assert ok
        gt = [frame(i)["T_cw_gt"] for i in range(n)]
        paired = [(fid, T) for fid, T in fe.trajectory if fid < n]
        assert ate_rmse_aligned(paired, [gt[fid] for fid, _ in paired]) < 0.05

    def test_pipelined_matches_sync(self):
        n = 12
        gt = [frame(i)["T_cw_gt"] for i in range(n)]
        fe_s, _ = run_mono(n)
        fe_p = MonoFrontend(CAM, device=CPU)
        fe_p.process_first_frame(frame(0))
        for i in range(1, n):
            r = fe_p.process_frame_pipelined(frame(i))
            assert r is None or r[0], f"pipelined failed at {i}"
        for ok, _d, _f in fe_p.flush_pipeline():
            assert ok
        assert len(fe_p.trajectory) == len(fe_s.trajectory)
        ate_s = ate_rmse_aligned(fe_s.trajectory, gt)
        ate_p = ate_rmse_aligned(fe_p.trajectory, gt)
        assert ate_p < max(2.0 * ate_s, 0.02), (ate_s, ate_p)

    def test_relocalization_after_kidnap(self):
        n = 12
        fe, _ = run_mono(n)
        pr = mono_loop.make_mono_place_recognizer(fe, score_thr=0.05)
        pr.add_location({"kf_id": 0, "img": frame(0)["left"],
                         "disp": None, "exclude": {0}})
        # the camera is back at frame 1's pose while the belief carries a
        # large yaw
        kidnap = frame(1)
        yaw = SE3.exp(torch.tensor([0, 0, 0, 0.0, 0.7, 0.0]))
        fe._R_cw = yaw.R.numpy() @ fe._R_cw
        fe._dev_R_cw = None
        fe._dev_t_cw = None
        ok, _ = fe.process_frame(kidnap)
        assert not ok, "corrupted belief should break guided matching"
        assert fe.relocalize(pr, kidnap)
        err = np.linalg.norm(fe._t_cw - kidnap["T_cw_gt"].t)
        assert err < 0.15, err
        ok, _ = fe.process_frame(frame(2))
        assert ok

    def test_keyframe_switch_retargets(self):
        fe = MonoFrontend(CAM, device=CPU)
        for k, t in ((0, np.zeros(3, np.float32)),
                     (1, np.array([0.5, 0, 0], np.float32))):
            fe.pose_np[k] = (np.eye(3, dtype=np.float32), t)
        fe.actkey_id = 1
        fe.covis = {1: {0: 150}, 0: {1: 150}}
        fe._R_cw = np.eye(3, dtype=np.float32)
        fe._t_cw = np.array([0.05, 0, 0], np.float32)  # near kf0, far kf1
        ids = np.arange(120, dtype=np.int64)
        fe._meta_anchor[ids] = 0  # >100 shared features anchored at kf0
        fe._tracked_ids = ids
        assert fe._maybe_switch_keyframe(t_norm=0.45)
        assert fe.actkey_id == 0
        fe.actkey_id = 1
        fe._tracked_ids = ids[:50]
        assert not fe._maybe_switch_keyframe(t_norm=0.45)

    def test_checkpoint_resume(self, tmp_path):
        from scavislam_tpu_torch.utils.serialization import (
            load_mono_system,
            save_mono_system,
        )

        n = 14
        fe = MonoFrontend(CAM, device=CPU)
        fe.process_first_frame(frame(0))
        for i in range(1, 8):
            ok, _ = fe.process_frame(frame(i))
            assert ok
        p = str(tmp_path / "mono.npz")
        save_mono_system(fe, p)

        fe2 = load_mono_system(p, CAM, device=CPU)
        assert torch.equal(fe2.points.psi, fe.points.psi)
        assert torch.equal(fe2.Lam, fe.Lam)
        assert fe2.pose_np.keys() == fe.pose_np.keys()
        assert fe2.kf_obs.keys() == fe.kf_obs.keys()
        for k in fe.kf_obs:
            np.testing.assert_array_equal(fe2.kf_obs[k][0], fe.kf_obs[k][0])
        assert len(fe2.trajectory) == len(fe.trajectory)

        for i in range(8, n):
            ok1, _ = fe.process_frame(frame(i))
            ok2, _ = fe2.process_frame(frame(i))
            assert ok1 and ok2
        np.testing.assert_allclose(fe2.trajectory[-1][1].t,
                                   fe.trajectory[-1][1].t, atol=1e-5)
        gt = [frame(i)["T_cw_gt"] for i in range(n)]
        assert ate_rmse_aligned(fe2.trajectory, gt) < 0.05

    def test_cli_end_to_end(self, tmp_path, capsys):
        from scavislam_tpu_torch.apps import mono_vo

        cfg = tmp_path / "mono.cfg"
        cfg.write_text(
            "cam.width = 128;\ncam.height = 96;\ncam.f = 130.0;\n"
            "cam.px = 63.5;\ncam.py = 47.5;\ncam.baseline = 0.12;\n")
        out = mono_vo.main([
            str(cfg), "--synthetic", "10", "--synthetic-step", "0.035",
            "--out", str(tmp_path / "traj.txt"), "--loop-close",
            "--device", "cpu"])
        assert out["frames"] == 10
        assert out["keyframes"] >= 1
        assert out["converged_points"] > 50
        assert out["ate_sim3_m"] < 0.05
        rows = np.loadtxt(tmp_path / "traj.txt")
        assert rows.shape == (10, 8)
        # the viewers: --viz, --viz-html and --watch each write their
        # artifacts
        from scavislam_tpu_torch.utils.png import decode_png

        watch = tmp_path / "watch"
        out = mono_vo.main([
            str(cfg), "--synthetic", "6", "--device", "cpu",
            "--viz", str(tmp_path / "map.png"),
            "--viz-html", str(tmp_path / "map3d.html"),
            "--watch", str(watch), "--watch-period", "0"])
        assert out["frames"] == 6
        assert decode_png((tmp_path / "map.png").read_bytes()).shape == (
            900, 900, 3)
        html = (tmp_path / "map3d.html").read_text()
        scene = json.loads(html.split("const SCENE = ", 1)[1]
                           .split(";\n", 1)[0])
        assert len(scene["kf_ids"]) == out["keyframes"]
        assert len(scene["points"]) > 0  # the converged points
        status = json.loads((watch / "status.json").read_text())
        assert status == {"frame": 5, "keyframes": out["keyframes"],
                          "lost": False, "relocalizations": 0}
        assert (watch / "map3d.html").exists()
        assert "watch:" not in capsys.readouterr().err

    def test_dataset_replay_cli(self, tmp_path):
        from scavislam_tpu_torch.apps import dump_sequence, mono_vo

        cfg = tmp_path / "mono.cfg"
        cfg.write_text(
            "cam.width = 128;\ncam.height = 96;\ncam.f = 130.0;\n"
            "cam.px = 63.5;\ncam.py = 47.5;\ncam.baseline = 0.12;\n")
        dump = str(tmp_path / "dump")
        dump_sequence.main([dump, "6", "--step", "0.035", "--config",
                            str(cfg), "--device", "cpu"])
        out = mono_vo.main([str(cfg), "--dataset", dump, "--device", "cpu"])
        assert out["frames"] == 6
        assert out["converged_points"] > 30

    def test_keyframes_and_covisibility(self):
        fe, _ = run_mono(16, cfg=_cfg(Config, 0.3))
        assert fe.next_kf >= 2, "no keyframe was dropped on this baseline"
        for kf, nbrs in fe.covis.items():
            for nbr, s in nbrs.items():
                assert fe.covis[nbr].get(kf, 0) == s


@pytest.mark.slow
class TestMonoDwo:
    def test_double_window_constraints_and_refinement(self):
        fe, _ = run_mono(26, cfg=_cfg(Config, 0.12))
        assert fe.next_kf >= 6, f"need a long keyframe chain, got {fe.next_kf}"
        inner_n = 3
        meta = fe._assemble_window_dwo(inner_n, 8)
        assert meta is not None
        assert len(meta["kf_ids"]) > inner_n
        assert meta["n_edges"] >= 1
        assert fe.edge_constraints
        P_cap, L_cap, O_cap, E_cap = fe.DWO_CAPS
        assert meta["prob"].R.shape == (P_cap, 3, 3)
        assert meta["prob"].edge_R.shape == (E_cap, 3, 3)
        gauge_kf = min(meta["kf_ids"])
        gauge_before = tuple(map(np.copy, fe.pose_np[gauge_kf]))
        out = fe.window_ba(window=inner_n, iters=3, dwo=True, outer=8)
        assert out is not None
        chi2_0, chi2_1 = out
        assert chi2_1 <= chi2_0 * 1.001, (chi2_0, chi2_1)
        np.testing.assert_array_equal(fe.pose_np[gauge_kf][0],
                                      gauge_before[0])
        np.testing.assert_array_equal(fe.pose_np[gauge_kf][1],
                                      gauge_before[1])

    def test_outer_pose_held_by_frozen_constraint(self):
        fe, _ = run_mono(26, cfg=_cfg(Config, 0.12))
        inner_n = 3
        meta = fe._assemble_window_dwo(inner_n, 8)
        assert meta is not None and meta["n_edges"] >= 1
        inner, outer = fe._compute_double_window(fe.actkey_id, inner_n, 8)
        held = [b for (a, b) in fe.edge_constraints if b in outer]
        held += [a for (a, b) in fe.edge_constraints if a in outer]
        assert held, "no outer keyframe carries a frozen constraint"
        k_out = held[0]
        R_o, t_o = fe.pose_np[k_out]
        t_bad = t_o + np.array([0.05, -0.04, 0.06], np.float32)
        fe.pose_np[k_out] = (R_o, t_bad)
        fe.poses = fe.poses.set(k_out, SE3(torch.tensor(R_o),
                                           torch.tensor(t_bad)))
        out = fe.window_ba(window=inner_n, iters=4, dwo=True, outer=8)
        assert out is not None
        t_opt = fe.pose_np[k_out][1]
        assert (np.linalg.norm(t_opt - t_o)
                < 0.5 * np.linalg.norm(t_bad - t_o)), (t_o, t_bad, t_opt)

    def test_unmarginalize_on_inner_reentry(self):
        fe, _ = run_mono(26, cfg=_cfg(Config, 0.12))
        meta = fe._assemble_window_dwo(3, 8)
        assert meta is not None and fe.edge_constraints
        fe._assemble_window_dwo(fe.DWO_CAPS[0], 0)
        assert not fe.edge_constraints, fe.edge_constraints


def test_mono_vo_defaults_to_the_card(monkeypatch, tmp_path):
    # the command line runs on the card unless --device cpu is given
    from scavislam_tpu_torch.apps import mono_vo

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mono_vo.main(["--synthetic", "3"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mono_vo.main(["--synthetic", "3", "--watch", str(tmp_path)])

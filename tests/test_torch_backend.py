"""The port's backend pieces against the JAX package's on the same numpy
inputs, on the CPU: the monitors (tests/test_backend_integration.py's
channel tests), the padded map-store scatters, point materialization, the
prefiltered corner buckets, the backend's matcher, the fixed-trip robust
motion-only BA, the fused registration program's packed vector from one
shared snapshot, a global loop closure from a hand-made DetectedLoop, and
the Lie-algebra helpers the BA edges use.

The shared state comes from a short unthreaded run of the port's
SlamSystem at the JAX tests' 256x192 camera.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scavislam_tpu.core import lie as jlie
from scavislam_tpu.core.camera import StereoCamera as JCam
from scavislam_tpu.models import backend as jbe
from scavislam_tpu.models import map_store as jms
from scavislam_tpu.models import matcher as jmatch
from scavislam_tpu.models import pose_optimizer as jpo
from scavislam_tpu.ops import fast as jfast
from scavislam_tpu.utils.config import Config as JConfig
from scavislam_tpu_torch import interop
from scavislam_tpu_torch.core import lie as tlie
from scavislam_tpu_torch.core.lie import PoseRT
from scavislam_tpu_torch.io.synthetic import SyntheticSequence
from scavislam_tpu_torch.models import backend as tbe
from scavislam_tpu_torch.models import map_store as tms
from scavislam_tpu_torch.models import matcher as tmatch
from scavislam_tpu_torch.models import pose_optimizer as tpo
from scavislam_tpu_torch.ops import fast as tfast
from scavislam_tpu_torch.pipeline.monitors import (
    FifoChannel,
    LatestValueCell,
    PlaceRecognizerMonitor,
    StackChannel,
)
from scavislam_tpu_torch.pipeline.slam_system import SlamSystem
from scavislam_tpu_torch.utils.config import Config as TConfig

J_CAM = JCam.create(195.0, (127.0, 95.0), (256, 192), 0.12)
T_CAM = interop.camera(np.asarray(J_CAM.focal), np.asarray(J_CAM.pp),
                       J_CAM.size, np.asarray(J_CAM.baseline))
SENTINEL = 1 << 30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (tests run one process per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(cls):
    # tests/test_backend_integration.py's run_system configuration, with an
    # inner window of 2 so that the first keyframe leaves it
    c = cls()
    return dataclasses.replace(
        c, frontend=dataclasses.replace(c.frontend, covis_thr=10),
        ui=dataclasses.replace(c.ui, parallax_thr=0.12),
        graph=dataclasses.replace(c.graph, inner_window=2, outer_window=20))


@pytest.fixture(scope="module")
def system():
    """12 frames through the port's unthreaded SlamSystem."""
    seq = SyntheticSequence(T_CAM, n_frames=12, step=0.05, device="cpu")
    s = SlamSystem(T_CAM, _cfg(TConfig), threaded=False,
                   enable_loop_closure=False, device="cpu")
    s.process_first_frame(seq.frame(0))
    for i in range(1, 12):
        assert s.process_frame(seq.frame(i))
    s.finish()
    return s


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_tables(points, poses):
    return (jms.PointTable(*[jnp.asarray(_np(x)) for x in points]),
            jms.PoseTable(*[jnp.asarray(_np(x)) for x in poses]))


# -- monitors (tests/test_backend_integration.py:24-67) ---------------------- #

class TestMonitors:
    def test_fifo(self):
        c = FifoChannel()
        c.push(1)
        c.push(2)
        assert c.pop() == 1 and c.pop() == 2 and c.pop() is None

    def test_latest_value_overwrites(self):
        c = LatestValueCell()
        c.set(1)
        c.set(2)
        assert c.take() == 2
        assert c.take() is None

    def test_stack(self):
        c = StackChannel()
        c.push(1)
        c.push(2)
        assert c.pop() == 2 and c.pop() == 1

    def test_place_monitor_keeps_newest_and_blocks_on_loop(self):
        m = PlaceRecognizerMonitor()
        m.addKeyframeData("a")
        m.addKeyframeData("b")
        assert m.getKeyframeDate() == "b"
        m.addLoop("loop1")
        m.addKeyframeData("c")  # refused: loop pending
        assert m.getKeyframeDate() is None
        assert m.getLoop() == "loop1"
        m.addKeyframeData("d")
        assert m.getKeyframeDate() == "d"

    def test_place_monitor_lossless_fifo(self):
        m = PlaceRecognizerMonitor(lossless=True)
        m.addKeyframeData("a")
        m.addKeyframeData("b")
        m.addLoop("loop1")
        m.addKeyframeData("c")  # not refused despite the pending loop
        assert m.pending()
        assert [m.getKeyframeDate() for _ in range(3)] == ["a", "b", "c"]
        assert m.getLoop() == "loop1"
        assert not m.pending()


# -- map store ------------------------------------------------------------- #

def test_padded_scatters_drop_sentinel_rows():
    # ids padded with 1 << 30 (and a negative id) are dropped, never clamped
    # into the last row; the same tables as the twin's drop-mode scatters
    rng = np.random.RandomState(0)
    K, C = 16, 8
    R0 = rng.randn(K, 3, 3).astype(np.float32)
    t0 = rng.randn(K, 3).astype(np.float32)
    v0 = rng.uniform(size=K) < 0.5
    idx = np.array([3, SENTINEL, 15, -1, SENTINEL, 0, SENTINEL, SENTINEL],
                   np.int32)
    Rs = rng.randn(C, 3, 3).astype(np.float32)
    ts = rng.randn(C, 3).astype(np.float32)
    tp = interop.pose_table(R0, t0, v0).set_many(torch.as_tensor(idx),
                                                 torch.as_tensor(Rs),
                                                 torch.as_tensor(ts))
    jp = jms.PoseTable(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(v0))
    jp = jp.set_many(jnp.asarray(np.where(idx < 0, SENTINEL, idx)),
                     jnp.asarray(Rs), jnp.asarray(ts))
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(tp.R[K - 1].numpy(), Rs[2])  # a real row-15 write
    untouched = [k for k in range(K) if k not in (0, 3, 15)]
    np.testing.assert_array_equal(tp.R.numpy()[untouched], R0[untouched])

    psi0 = rng.randn(K, 3).astype(np.float32)
    vals = rng.randn(C, 3).astype(np.float32)
    pids = np.array([1, SENTINEL, 7, SENTINEL, SENTINEL, SENTINEL, 2,
                     SENTINEL], np.int32)
    out_t = tms.scatter_psi(torch.as_tensor(psi0), torch.as_tensor(pids),
                            torch.as_tensor(vals)).numpy()
    out_j = np.asarray(jms.scatter_psi(jnp.asarray(psi0), jnp.asarray(pids),
                                       jnp.asarray(vals)))
    np.testing.assert_array_equal(out_t, out_j)
    np.testing.assert_array_equal(out_t[K - 1], psi0[K - 1])


def test_materialize_points_matches_jax(system):
    pts, poses = system.backend._last_tables
    jpts, jposes = _jax_tables(pts, poses)
    ids = np.concatenate([np.arange(0, 900, 3), [-1, -1]]).astype(np.int64)
    out_t = tms.materialize_points(poses, pts, torch.as_tensor(ids))
    out_j = jms.materialize_points(jposes, jpts, jnp.asarray(ids))
    for name, a, b in zip(("xyz_w", "R_aw", "t_aw", "patch", "ok"),
                          out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   err_msg=name)
    assert not out_t[4][-2:].any() and out_t[4].sum() > 50


# -- ops and matcher ------------------------------------------------------- #

def _snapshot(system, kf=None):
    be = system.backend
    kf = max(be.keyframe_snapshots) if kf is None else kf
    return kf, be.keyframe_snapshots[kf]


def test_corner_buckets_prefiltered_match_jax(system):
    # the registration's re-detection at every pyramid level: identical
    # corners, scores within 1e-6
    _, snap = _snapshot(system)
    for img in snap["pyr"]:
        h, w = img.shape
        kw = dict(cells_y=max(h // 8, 4), cells_x=max(w // 8, 4), per_cell=4)
        bt = tfast.corner_buckets_prefiltered(img, **kw)
        bj = jfast.corner_buckets_prefiltered(jnp.asarray(img.numpy()), **kw)
        np.testing.assert_array_equal(bt["valid"].numpy(),
                                      np.asarray(bj["valid"]))
        v = bt["valid"].numpy()
        np.testing.assert_array_equal(bt["uv"].numpy()[v],
                                      np.asarray(bj["uv"])[v])
        np.testing.assert_allclose(bt["score"].numpy(), np.asarray(bj["score"]),
                                   atol=1e-6)


def _match_inputs(system):
    kf, snap = _snapshot(system)
    pts, poses = system.backend._last_tables
    ids = torch.as_tensor(np.flatnonzero(pts.valid.numpy())[:600])
    xyz_w, R_aw, t_aw, patches, ok = tms.materialize_points(poses, pts, ids)
    T = system.backend.graph.vertices[kf].T
    return snap, T, xyz_w, R_aw, t_aw, patches, ok, pts.level[ids]


def test_match_level_matches_jax(system):
    # every level, radius 15: the same matched set, observations within
    # 1e-4 px
    snap, T, xyz_w, R_aw, t_aw, patches, ok, lvl = _match_inputs(system)
    for l, img in enumerate(snap["pyr"]):
        c = T_CAM.scale_level(l)
        h, w = img.shape
        b = tfast.corner_buckets_prefiltered(img, cells_y=h // 8,
                                             cells_x=w // 8, per_cell=4)
        args = ((c.focal, c.pp[0], c.pp[1], c.baseline), (w, h))
        valid = ok & (lvl == l)
        rt = tmatch._match_level(
            *args, img, torch.as_tensor(T.R), torch.as_tensor(T.t), xyz_w,
            R_aw, t_aw, patches, valid, b["uv"], b["valid"], snap["disp"],
            l, 0.18, 15.0)
        rj = jmatch._match_level(
            *args, *(jnp.asarray(_np(x)) for x in (
                img, T.R, T.t, xyz_w, R_aw, t_aw, patches, valid, b["uv"],
                b["valid"], snap["disp"])), l, 0.18, 15.0)
        m = rt.matched.numpy()
        np.testing.assert_array_equal(m, np.asarray(rj.matched))
        assert l > 0 or m.sum() > 50
        np.testing.assert_allclose(rt.obs_uvu.numpy()[m],
                                   np.asarray(rj.obs_uvu)[m], atol=1e-4)


def test_capture_and_public_match_level_match_jax(system):
    # source patches captured at level-0 corners (some near the border, so
    # the in-image mask has both values) within 1e-6; the public
    # match_level wrapper gives the matched set and observations (1e-4 px)
    snap, T, xyz_w, R_aw, t_aw, patches, ok, lvl = _match_inputs(system)
    img = snap["pyr"][0]
    rng = np.random.RandomState(5)
    uv = np.stack([rng.uniform(0, 256, 64), rng.uniform(0, 192, 64)],
                  -1).astype(np.float32)
    pt, okt = tmatch.capture_source_patches(img, torch.as_tensor(uv))
    pj, okj = jmatch.capture_source_patches(jnp.asarray(img.numpy()),
                                            jnp.asarray(uv))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert 0 < okt.sum() < len(uv)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6)

    h, w = img.shape
    b = tfast.corner_buckets_prefiltered(img, cells_y=h // 8, cells_x=w // 8,
                                         per_cell=4)
    valid = ok & (lvl == 0)
    rt = tmatch.match_level(
        T_CAM, img, tlie.SE3(torch.as_tensor(T.R), torch.as_tensor(T.t)),
        xyz_w, tlie.SE3(R_aw, t_aw), patches, valid, b, snap["disp"], 0)
    jarr = [jnp.asarray(_np(x)) for x in (img, T.R, T.t, xyz_w, R_aw, t_aw,
                                          patches, valid, snap["disp"])]
    rj = jmatch.match_level(
        J_CAM, jarr[0], jlie.SE3(jarr[1], jarr[2]), jarr[3],
        jlie.SE3(jarr[4], jarr[5]), jarr[6], jarr[7],
        {k: jnp.asarray(v.numpy()) for k, v in b.items()}, jarr[8], 0)
    m = rt.matched.numpy()
    np.testing.assert_array_equal(m, np.asarray(rj.matched))
    assert m.sum() > 20
    np.testing.assert_allclose(rt.obs_uvu.numpy()[m],
                               np.asarray(rj.obs_uvu)[m], atol=1e-4)


def test_motion_only_ba_robust_matches_jax(system):
    # the fixed-trip device loop against the twin's while_loop: pose within
    # 1e-5, chi2 within 1e-4 relative, the same inlier set
    _, _, xyz_w, _, _, _, ok, lvl = _match_inputs(system)
    kf, _ = _snapshot(system)
    Tg = system.backend.graph.vertices[kf].T
    rng = np.random.RandomState(4)
    y = xyz_w.numpy() @ Tg.R.T + Tg.t
    f, (px, py), bl = T_CAM.focal, T_CAM.pp, T_CAM.baseline
    obs = np.stack([y[:, 0] / y[:, 2] * f + px, y[:, 1] / y[:, 2] * f + py,
                    (y[:, 0] - bl) / y[:, 2] * f + px], -1)
    obs = obs + rng.randn(*obs.shape) * 0.3
    obs[::17] += 40.0  # gross outliers for the rejection round
    obs = obs.astype(np.float32)
    w = (0.25 ** lvl.numpy()).astype(np.float32)
    T0 = PoseRT(*_exp_pert(Tg, rng))
    rt = tpo.motion_only_ba_robust(
        T_CAM, tlie.SE3(torch.as_tensor(T0.R), torch.as_tensor(T0.t)),
        xyz_w, torch.as_tensor(obs), torch.as_tensor(w), ok,
        reject_thresh=4.0)
    rj = jpo.motion_only_ba_robust(
        J_CAM, jlie.SE3(jnp.asarray(T0.R), jnp.asarray(T0.t)),
        jnp.asarray(xyz_w.numpy()), jnp.asarray(obs), jnp.asarray(w),
        jnp.asarray(ok.numpy()), reject_thresh=4.0)
    np.testing.assert_allclose(rt.T.R.numpy(), np.asarray(rj.T.R), atol=1e-5)
    np.testing.assert_allclose(rt.T.t.numpy(), np.asarray(rj.T.t), atol=1e-5)
    assert abs(float(rt.chi2) - float(rj.chi2)) <= 1e-4 * float(rj.chi2)
    np.testing.assert_array_equal(rt.inlier_mask.numpy(),
                                  np.asarray(rj.inlier_mask))
    err = (PoseRT.from_any(rt.T) @ Tg.inverse()).t
    assert np.linalg.norm(err) < 0.01


def _exp_pert(T, rng):
    d = tlie.SE3.exp(torch.as_tensor(rng.randn(6) * 0.02, dtype=torch.float32))
    P = PoseRT.from_any(d) @ T
    return P.R.astype(np.float32), P.t.astype(np.float32)


def test_register_packed_matches_jax(system):
    # the fused two-pass registration from one shared snapshot: the pass-1
    # gate count, the gate and the levels exact, observations within 1e-3
    # px, the pose within 1e-4
    be = system.backend
    kf, snap = _snapshot(system)
    pts, poses = be._last_tables
    cand = np.flatnonzero(pts.valid.numpy())[:1024]
    T0 = be.graph.vertices[kf].T
    _, fut = be._match_and_align_dispatch(snap, T0, cand, pts, poses)
    pk_t = fut.result()
    jb = jbe.Backend(J_CAM, _cfg(JConfig))
    jsnap = {"pyr": tuple(jnp.asarray(x.numpy()) for x in snap["pyr"]),
             "disp": jnp.asarray(snap["disp"].numpy())}
    jpts, jposes = _jax_tables(pts, poses)
    _, futj = jb._match_and_align_dispatch(
        jsnap, jlie.SE3(jnp.asarray(T0.R), jnp.asarray(T0.t)), cand, jpts,
        jposes)
    pk_j = np.asarray(futj.result())
    C = tbe.CAND_CAP
    assert pk_t.shape == pk_j.shape == (1 + 5 * C + 12,)
    assert pk_t[0] == pk_j[0] >= 10
    np.testing.assert_array_equal(pk_t[1:1 + C], pk_j[1:1 + C])
    np.testing.assert_allclose(pk_t[1 + C:1 + 4 * C], pk_j[1 + C:1 + 4 * C],
                               atol=1e-3)
    np.testing.assert_array_equal(pk_t[1 + 4 * C:1 + 5 * C],
                                  pk_j[1 + 4 * C:1 + 5 * C])
    np.testing.assert_allclose(pk_t[-12:], pk_j[-12:], atol=1e-4)


def test_global_loop_closure_from_detected_loop(system):
    # a hand-made loop between the newest keyframe and keyframe 0 after
    # their covis edge is cut and 0 leaves the inner window: verified by
    # re-matching, an APPEARANCE edge inserted, the loop pushed, a solve
    # dispatched; the refusal branches count why
    be = system.backend
    g = be.graph
    q, l = max(g.vertices), 0
    Tq, Tl = g.vertices[q].T, g.vertices[l].T
    loop = tbe.DetectedLoop(q, l, Tq @ Tl.inverse())
    assert not be.global_loop_closure(tbe.DetectedLoop(q, 999, loop.T_query_from_loop))
    assert be.counters["glc_unknown_vertex"] == 1
    if g.find_edge(q, l) is not None:
        assert not be.global_loop_closure(loop)
        assert be.counters["glc_already_connected"] == 1
        del g.edges[g._key(q, l)]
        g.vertices[q].neighbor_strengths.pop(l, None)
        g.vertices[l].neighbor_strengths.pop(q, None)
    g.double_window[l] = tbe.OUTER
    n_solves = len(g.solve_log)
    assert be.global_loop_closure(loop)
    assert be.counters["glc_accepted"] == 1
    e = g.find_edge(q, l)
    assert e is not None and e.edge_type == 2  # APPEARANCE
    assert be.monitor.getClosedLoop() == (q, l)
    g.finish_pending()
    assert len(g.solve_log) == n_solves + 1
    assert g.stats["chi2_final"] <= g.stats["chi2_init"]
    assert not be.global_loop_closure(loop)  # now connected
    assert be.counters["glc_already_connected"] >= 1


# -- Lie helpers ------------------------------------------------------------ #

def test_lie_helpers_match_jax():
    rng = np.random.RandomState(8)
    a = rng.randn(16, 6).astype(np.float32)
    b = rng.randn(16, 6).astype(np.float32)
    np.testing.assert_allclose(
        tlie.lie_bracket_se3(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        np.asarray(jlie.lie_bracket_se3(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-6)
    ad = tlie.ad_se3(torch.as_tensor(a))
    np.testing.assert_array_equal(ad.numpy(),
                                  np.asarray(jlie.ad_se3(jnp.asarray(a))))
    np.testing.assert_allclose(
        (ad @ torch.as_tensor(b)[..., None])[..., 0].numpy(),
        tlie.lie_bracket_se3(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        atol=1e-5)
    A = rng.randn(40, 3)
    Rg = tlie.SO3.exp(torch.tensor([0.2, -0.1, 0.3], dtype=torch.float64)).R
    B = 1.7 * A @ Rg.numpy().T + np.array([0.5, -1.0, 2.0])
    s, R, t = tlie.umeyama_sim3(A, B)
    sj, Rj, tj = jlie.umeyama_sim3(A, B)
    assert abs(s - 1.7) < 1e-9 and abs(s - sj) < 1e-12
    np.testing.assert_allclose(R, Rj, atol=1e-7)
    np.testing.assert_allclose(t, tj, atol=1e-6)

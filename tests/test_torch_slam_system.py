"""The port's SlamSystem (frontend + backend + place recognizer) against
the JAX package's on the same frames, on the CPU: 12 frames unthreaded with
the configuration of tests/test_backend_integration.py's run_system,
synchronous and pipelined at depth 2, with loop closure off and on;
neighborhood adoption and reseed from one shared state; and the device
default of the entry points.

The JAX side hands its fetches and uploads to thread pools; here they get
an executor that runs inline and returns completed futures, so both sides
see every result landed at once and step deterministically (the port's
fetches complete at once on the CPU). With loop closure on, the port's
recognizer draws the JAX recognizer's RANSAC hypotheses, replayed from its
key chain (JaxDraws, from tests/test_torch_placerec.py).
"""

import dataclasses
from concurrent.futures import Future

import jax
import numpy as np
import pytest
import torch

from scavislam_tpu.core.camera import StereoCamera as JCam
from scavislam_tpu.io.synthetic import SyntheticSequence
from scavislam_tpu.models import frontend as jfe_mod
from scavislam_tpu.pipeline import slam_system as jss
from scavislam_tpu.utils.config import Config as JConfig
from scavislam_tpu_torch import interop
from scavislam_tpu_torch.models.backend import Backend
from scavislam_tpu_torch.models.frontend import StereoFrontend as TFrontend
from scavislam_tpu_torch.models.placerec import (PlaceRecognizer,
                                                 random_vocabulary)
from scavislam_tpu_torch.models.slam_graph import SlamGraph
from scavislam_tpu_torch.pipeline import slam_system as tss
from scavislam_tpu_torch.utils.config import Config as TConfig
from test_torch_placerec import JaxDraws

J_CAM = JCam.create(195.0, (127.0, 95.0), (256, 192), 0.12)
T_CAM = interop.camera(np.asarray(J_CAM.focal), np.asarray(J_CAM.pp),
                       J_CAM.size, np.asarray(J_CAM.baseline))
N_FRAMES = 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (tests run one process per core)."""
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


def _cfg(cls):
    # tests/test_backend_integration.py's run_system configuration
    c = cls()
    return dataclasses.replace(
        c, frontend=dataclasses.replace(c.frontend, covis_thr=10),
        ui=dataclasses.replace(c.ui, parallax_thr=0.12),
        graph=dataclasses.replace(c.graph, inner_window=5, outer_window=20))


@pytest.fixture(scope="module")
def frames():
    seq = SyntheticSequence(J_CAM, n_frames=N_FRAMES, step=0.05)
    out = []
    for i in range(N_FRAMES):
        f = seq.frame(i)
        out.append({"frame_id": i, "left": np.array(f["left"]),
                    "right": np.array(f["right"]),
                    "gt": (np.asarray(f["T_cw_gt"].R, np.float64),
                           np.asarray(f["T_cw_gt"].t, np.float64))})
    return out


def _host(f):
    return {"frame_id": f["frame_id"], "left": f["left"], "right": f["right"]}


def _record_best(pr):
    """Keep every add_location's last_best (the query's best candidate)."""
    pr.best_log = []
    add = pr.add_location

    def add_location(data):
        loop = add(data)
        pr.best_log.append(pr.last_best)
        return loop

    pr.add_location = add_location


def _run(system, frames):
    if isinstance(system, jss.SlamSystem):
        system.frontend._fetch_pool = _InlineExecutor()
        system.backend.graph._fetch_pool = _InlineExecutor()
        system.backend._reg_pool = _InlineExecutor()
    elif system.place_recognizer is not None:
        system.place_recognizer.hypotheses = JaxDraws(jax.random.PRNGKey(42))
    if system.place_recognizer is not None:
        _record_best(system.place_recognizer)
    system.process_first_frame(_host(frames[0]))
    for f in frames[1:]:
        assert system.process_frame(_host(f)), f["frame_id"]
    system.finish()
    return system


def _systems(frames, pipelined, loop_closure=False):
    kw = dict(threaded=False, enable_loop_closure=loop_closure,
              pipelined=pipelined, pipeline_depth=2 if pipelined else None)
    js = _run(jss.SlamSystem(J_CAM, _cfg(JConfig), **kw), frames)
    ts = _run(tss.SlamSystem(T_CAM, _cfg(TConfig), device="cpu", **kw),
              frames)
    return js, ts


@pytest.fixture(scope="module")
def sync_runs(frames):
    return _systems(frames, pipelined=False)


@pytest.fixture(scope="module")
def pipe_runs(frames):
    return _systems(frames, pipelined=True)


@pytest.fixture(scope="module", params=[False, True],
                ids=["sync", "pipelined"])
def lc_runs(request, frames):
    return _systems(frames, pipelined=request.param, loop_closure=True)


def _ate(system, frames):
    gt = {f["frame_id"]: f["gt"] for f in frames}
    return tss.ate_rmse(system.trajectory,
                        [gt[fid] for fid, _ in system.trajectory])


def _assert_same_run(js, ts, frames):
    gj, gt_ = js.backend.graph, ts.backend.graph
    assert ts.frontend.next_kf == js.frontend.next_kf >= 3
    assert sorted(gt_.vertices) == sorted(gj.vertices)
    assert sorted(gt_.vertices) == sorted(ts.frontend.keyframe_map)
    assert dict(ts.backend.counters) == dict(js.backend.counters)
    assert len(gt_.solve_log) == len(gj.solve_log) >= 1
    assert [n for n, _ in gt_.solve_log] == [n for n, _ in gj.solve_log]
    assert [f for f, _ in ts.trajectory] == [f for f, _ in js.trajectory]
    assert len(ts.trajectory) == N_FRAMES
    a_j, a_t = _ate(js, frames), _ate(ts, frames)
    assert abs(a_t - a_j) <= max(0.01 * a_j, 1e-4), (a_t, a_j)
    assert a_t < 0.03


def test_sync_run_matches_jax(sync_runs, frames):
    # the same keyframe count and graph vertex set, the same backend
    # counters and solve count, ATE within max(1% of JAX's, 1e-4)
    _assert_same_run(*sync_runs, frames)


def test_sync_graph_state_matches_jax(sync_runs):
    # the same covis edges and double window; optimized keyframe poses
    # within 1e-3 m
    js, ts = sync_runs
    gj, gt_ = js.backend.graph, ts.backend.graph
    assert list(gt_.edges) == list(gj.edges)
    assert list(gt_.double_window.items()) == list(gj.double_window.items())
    for k in gj.vertices:
        np.testing.assert_allclose(gt_.vertices[k].t, gj.vertices[k].t,
                                   atol=1e-3)
    assert ts.frontend.neighborhood is not None
    assert ts.frontend.neighborhood["root"] == js.frontend.neighborhood["root"]


def test_pipelined_run_matches_jax(pipe_runs, frames):
    # depth 2, the backend answering queries at the newest inserted
    # ancestor: the same numbers as the synchronous parity test
    _assert_same_run(*pipe_runs, frames)


def test_ate_rmse_aligned_matches_jax(sync_runs, frames):
    js, ts = sync_runs
    gt = [f["gt"] for f in frames]
    for scale in (True, False):
        a_t = tss.ate_rmse_aligned(ts.trajectory, gt, with_scale=scale)
        a_j = jss.ate_rmse_aligned(js.trajectory, gt, with_scale=scale)
        assert abs(a_t - a_j) <= max(0.01 * a_j, 1e-4)
    assert ts.export_trajectory().shape == (N_FRAMES, 7)


def _snapshot(fe):
    """A JAX frontend's state as numpy, for interop.load_frontend_state."""
    n = np.asarray
    return dict(
        poses=interop.pose_table(n(fe.poses.R), n(fe.poses.t),
                                 n(fe.poses.valid)),
        points=interop.point_table(*[n(x) for x in fe.points]),
        dense=interop.dense_state(
            [n(x) for x in fe._prev_clouds], [n(x) for x in fe._prev_intens],
            [n(x) for x in fe._prev_valids], [n(x) for x in fe._prev_J]),
        R_cw=n(fe._R_cw), t_cw=n(fe._t_cw), R_cak=n(fe._R_cak),
        t_cak=n(fe._t_cak), actkey_id=fe.actkey_id, next_kf=fe.next_kf,
        next_point=fe.next_point, kf_point_ids=dict(fe.kf_point_ids),
        covis=dict(fe.covis), pose_np=dict(fe.pose_np),
        meta_anchor=fe._meta_anchor, meta_level=fe._meta_level,
        frame_id=fe.frame_id)


def _shared_frontends(sync_runs):
    """A fresh JAX frontend and a port frontend, both in the state of the
    JAX run's frontend (device pose chain included), with one fake
    in-flight pipelined entry each."""
    js, _ = sync_runs
    src = js.frontend
    jf = jfe_mod.StereoFrontend(J_CAM, _cfg(JConfig))
    jf._fetch_pool = _InlineExecutor()
    for k in ("poses", "points", "_prev_clouds", "_prev_intens",
              "_prev_valids", "_prev_J", "_R_cw", "_t_cw", "_R_cak",
              "_t_cak", "actkey_id", "next_kf", "next_point", "kf_point_ids",
              "covis", "pose_np", "_meta_anchor", "_meta_level", "frame_id",
              "_dev_R_cw", "_dev_t_cw"):
        setattr(jf, k, getattr(src, k))
    jf.pose_np = dict(src.pose_np)
    tf = TFrontend(T_CAM, _cfg(TConfig), device="cpu")
    interop.load_frontend_state(tf, **_snapshot(src))
    tf._dev_R_cw = interop.tensor(src._dev_R_cw)
    tf._dev_t_cw = interop.tensor(src._dev_t_cw)
    cand = tf._collect_candidates()
    jf._pending.append([99, cand, None, None, None, None, 0])
    tf._pending.append([99, cand, None, None, None, None, 0])
    return jf, tf


def test_apply_neighborhood_from_shared_state(sync_runs):
    # the JAX backend's neighborhood adopted by both frontends from one
    # state: the same host mirrors, world pose and in-flight correction,
    # the same candidate ids, and after the fused scatter the same device
    # tables (poses and psi bit for bit)
    js, _ = sync_runs
    jf, tf = _shared_frontends(sync_runs)
    nb = js.backend.compute_neighborhood(jf.actkey_id)
    # move the neighborhood a little so that the adoption rebases
    for k, (R, t) in nb["poses"].items():
        nb["poses"][k] = (R, t + np.array([0.01, -0.005, 0.002]))
    nb["psi_vals"] = nb["psi_vals"] * 1.01
    assert tf.apply_neighborhood(nb) == jf.apply_neighborhood(nb) is True
    for k in nb["kf_ids"]:
        np.testing.assert_array_equal(tf.pose_np[k][0], jf.pose_np[k][0])
        np.testing.assert_array_equal(tf.pose_np[k][1], jf.pose_np[k][1])
    np.testing.assert_allclose(tf._R_cw, jf._R_cw, atol=1e-6)
    np.testing.assert_allclose(tf._t_cw, jf._t_cw, atol=1e-6)
    np.testing.assert_allclose(tf._dev_R_cw.numpy(), np.asarray(jf._dev_R_cw),
                               atol=1e-6)
    np.testing.assert_allclose(tf._dev_t_cw.numpy(), np.asarray(jf._dev_t_cw),
                               atol=1e-6)
    for i in (4, 5):
        np.testing.assert_allclose(tf._pending[0][i], jf._pending[0][i],
                                   atol=1e-6)
    np.testing.assert_array_equal(tf._collect_candidates(),
                                  jf._collect_candidates())
    tf._apply_nb_pending(block=True)
    jf._apply_nb_pending(block=True)
    for a, b in zip(tf.poses, jf.poses):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tf.points.psi.numpy(),
                                  np.asarray(jf.points.psi))
    # a neighborhood of another region (no covis link) is refused
    far = dict(nb, kf_ids=[10_000])
    assert tf.apply_neighborhood(far) == jf.apply_neighborhood(far) is False


def test_reseed_from_shared_state(sync_runs):
    jf, tf = _shared_frontends(sync_runs)
    k = min(jf.pose_np)
    R = np.asarray(jf.pose_np[k][0], np.float32)
    t = np.asarray(jf.pose_np[k][1], np.float32) + np.float32(0.05)
    jf.reseed(R, t, actkey_id=k)
    tf.reseed(R, t, actkey_id=k)
    assert tf.actkey_id == jf.actkey_id == k
    assert not tf._pending and tf._dev_R_cw is None and tf._cand_np is None
    np.testing.assert_array_equal(tf._R_cak, jf._R_cak)
    np.testing.assert_array_equal(tf._t_cak, jf._t_cak)


def test_loop_closure_run_matches_jax(lc_runs, frames):
    # loop closure on, as the twin defaults: the same keyframes,
    # trajectory and ATE as the loop-closure-off runs hold, the same
    # indexed places, every place from its keyframe's pr_packed block (no
    # describe of its own), and every query's best candidate equal with its
    # score within 1e-4 relative
    js, ts = lc_runs
    _assert_same_run(js, ts, frames)
    jp, tp = js.place_recognizer, ts.place_recognizer
    assert list(tp.location_map) == list(jp.location_map)
    assert sorted(tp.location_map) == sorted(ts.frontend.keyframe_map)
    assert tp.counters["indexed"] == jp.counters["indexed"] == len(
        tp.location_map)
    assert tp.counters["described"] == 0
    assert len(tp.best_log) == len(jp.best_log) == len(tp.location_map)
    for bt, bj in zip(tp.best_log, jp.best_log):
        assert (bt is None) == (bj is None)
        if bj is not None:
            assert bt[0] == bj[0]
            np.testing.assert_allclose(bt[1], bj[1], rtol=1e-4)
    assert ts.closed_loops == js.closed_loops
    assert not ts.lost and ts.relocalizations == 0


def test_loop_closure_places_match_jax(lc_runs):
    # each place's pr_packed block within the bow_describe tolerances:
    # valid and (u, v) equal, descriptors within 1e-5 abs, words equal on
    # >= 99% of the valid rows; d and xyz within 1e-5 relative (the block's
    # input disparity is the frame step's, which agrees with the twin's to
    # float rounding, not bit for bit: sub-pixel fits differ by an ulp)
    js, ts = lc_runs
    same = total = 0
    for k, pj in js.place_recognizer.location_map.items():
        pt = ts.place_recognizer.location_map[k]
        dj, xj, vj = (np.asarray(a) for a in pj.padded)
        dt, xt, vt = pt.padded
        np.testing.assert_array_equal(vt, vj)
        assert vj.sum() > 50
        np.testing.assert_allclose(dt[vj], dj[vj], atol=1e-5, rtol=0)
        np.testing.assert_allclose(xt[vj], xj[vj], atol=1e-6, rtol=1e-5)
        np.testing.assert_array_equal(pt.uvd[:, :2], np.asarray(pj.uvd)[:, :2])
        np.testing.assert_allclose(pt.uvd[:, 2], np.asarray(pj.uvd)[:, 2],
                                   atol=1e-6, rtol=1e-5)
        assert pt.exclude == pj.exclude
        same += int((pt.words == np.asarray(pj.words)).sum())
        total += len(pj.words)
    print(f"pr_packed words equal on {same}/{total} valid rows")
    assert same >= 0.99 * total, (same, total)


ENTRY_POINTS = {
    "SlamSystem": lambda **kw: tss.SlamSystem(
        T_CAM, enable_loop_closure=False, **kw),
    "Backend": lambda **kw: Backend(T_CAM, **kw),
    "SlamGraph": lambda **kw: SlamGraph(T_CAM, **kw),
    "PlaceRecognizer": lambda **kw: PlaceRecognizer(
        T_CAM, random_vocabulary(), **kw),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_device_default_raises_without_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name]()
    assert ENTRY_POINTS[name](device="cpu").device == torch.device("cpu")

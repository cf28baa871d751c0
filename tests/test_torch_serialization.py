"""The port's checkpoints (utils/serialization.py) against the JAX
package's on the CPU: a graph, a system and a mono checkpoint written by
either package load in the other with the tables equal, and the TUM
trajectory export gives the same bytes. The twin's test_aux.py
serialization cases and test_relocalization.py's map reuse are mirrored on
the port."""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scavislam_tpu.core.camera import StereoCamera as JCam
from scavislam_tpu.core.lie import SE3 as JSE3
from scavislam_tpu.models import slam_graph as jsg
from scavislam_tpu.models.mono_frontend import MonoFrontend as JMono
from scavislam_tpu.models.placerec import Place as JPlace
from scavislam_tpu.pipeline.slam_system import SlamSystem as JSystem
from scavislam_tpu.utils import serialization as jser
from scavislam_tpu_torch import interop
from scavislam_tpu_torch.core.lie import SE3
from scavislam_tpu_torch.models import slam_graph as tsg
from scavislam_tpu_torch.models.placerec import Place
from scavislam_tpu_torch.utils import serialization as tser

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_slam_graph import J_CAM, T_CAM, build, make_inputs  # noqa: E402

CPU = torch.device("cpu")
# the twin's mono test camera
J_MONO_CAM = JCam.create(130.0, (63.5, 47.5), (128, 96), 0.12)
T_MONO_CAM = interop.camera(np.asarray(J_MONO_CAM.focal),
                            np.asarray(J_MONO_CAM.pp), J_MONO_CAM.size,
                            np.asarray(J_MONO_CAM.baseline))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graphs(n_kf=6):
    """The same add_keyframe sequence on a JAX and a port graph, both
    prepared for optimization (so that edges are marginalized)."""
    calls, _ = make_inputs(n_kf, perturb=0.01)
    gj = build(jsg, calls, J_CAM)
    gt = build(tsg, calls, T_CAM)
    assert gj.prepare_for_optimization(n_kf - 1)
    assert gt.prepare_for_optimization(n_kf - 1)
    return gj, gt


def _assert_graphs_equal(a, b):
    assert list(a.vertices) == list(b.vertices)
    assert set(a.points) == set(b.points)
    assert set(a.edges) == set(b.edges)
    for k in a.vertices:
        np.testing.assert_array_equal(np.asarray(a.vertices[k].R),
                                      np.asarray(b.vertices[k].R))
        np.testing.assert_array_equal(np.asarray(a.vertices[k].t),
                                      np.asarray(b.vertices[k].t))
        assert (a.vertices[k].neighbor_strengths
                == b.vertices[k].neighbor_strengths)
        assert set(a.vertices[k].feature_table) == set(
            b.vertices[k].feature_table)
        for pid, (uvu, lvl) in a.vertices[k].feature_table.items():
            uvu_b, lvl_b = b.vertices[k].feature_table[pid]
            np.testing.assert_array_equal(uvu, uvu_b)
            assert lvl == lvl_b
    for p in a.points:
        np.testing.assert_array_equal(a.points[p].psi, b.points[p].psi)
        assert a.points[p].vis_set == b.points[p].vis_set
        assert (a.points[p].anchor_id, a.points[p].level) == (
            b.points[p].anchor_id, b.points[p].level)
    for e in a.edges:
        ea, eb = a.edges[e], b.edges[e]
        assert (ea.strength, ea.edge_type) == (eb.strength, eb.edge_type)
        assert ea.is_marginalized() == eb.is_marginalized()
        if ea.is_marginalized():
            np.testing.assert_array_equal(ea.Lambda, eb.Lambda)
            np.testing.assert_array_equal(ea.R_1_from_2, eb.R_1_from_2)
    for attr in ("covis_thr", "inner_window_size", "double_window_size"):
        assert getattr(a, attr) == getattr(b, attr)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_graph_loads_across_packages(tmp_path, writer):
    # a graph written by one package loads in the other with every table
    # equal; each package's own file matches the other's content
    gj, gt = _graphs()
    p = str(tmp_path / "map.npz")
    if writer == "jax":
        jser.save_graph(gj, p)
        loaded = tser.load_graph(p, T_CAM, device=CPU)
        _assert_graphs_equal(gj, loaded)
    else:
        tser.save_graph(gt, p)
        loaded = jser.load_graph(p, J_CAM)
        _assert_graphs_equal(gt, loaded)
    q = str(tmp_path / "other.npz")
    (tser.save_graph(gt, q) if writer == "jax" else jser.save_graph(gj, q))
    za, zb = np.load(p), np.load(q)
    assert sorted(za.files) == sorted(zb.files)
    assert str(za["meta"]) == str(zb["meta"])


def test_tum_export_same_bytes_as_jax(tmp_path):
    # the same trajectory (f32 poses, host and device types) through both
    # exporters: identical files
    rng = np.random.RandomState(0)
    xis = rng.randn(7, 6).astype(np.float32) * 0.3
    traj_t = [(i, SE3.exp(torch.tensor(x))) for i, x in enumerate(xis)]
    traj_j = [(i, JSE3(jnp.asarray(T.R.numpy()), jnp.asarray(T.t.numpy())))
              for i, T in traj_t]
    pt, pj = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    tser.save_trajectory_tum(traj_t, pt)
    jser.save_trajectory_tum(traj_j, pj)
    assert open(pt, "rb").read() == open(pj, "rb").read()


def _random_mono_state(fe, rng, tables):
    """Fill a mono frontend (either package) with a seeded state."""
    P = tables["psi"].shape[0]
    fe.next_kf, fe.next_point, fe.actkey_id = 3, 900, 2
    fe.kf_point_ids = {k: np.arange(k * 300, k * 300 + 250, dtype=np.int64)
                       for k in range(3)}
    fe.kf_obs = {k: (np.arange(k * 300, k * 300 + 40, dtype=np.int64),
                     rng.rand(40, 2).astype(np.float32) * 90)
                 for k in range(3)}
    fe.covis = {0: {1: 40}, 1: {0: 40, 2: 33}, 2: {1: 33}}
    fe.pose_np = {k: (np.eye(3, dtype=np.float32),
                      rng.randn(3).astype(np.float32)) for k in range(3)}
    fe._meta_anchor = rng.randint(-1, 3, P).astype(np.int64)
    fe._meta_level = rng.randint(0, 3, P).astype(np.int64)


def _mono_tables(rng, P):
    return {"psi": rng.randn(P, 3).astype(np.float32),
            "anchor": rng.randint(0, 3, P).astype(np.int32),
            "level": rng.randint(0, 3, P).astype(np.int32),
            "patch": rng.rand(P, 16, 16).astype(np.float32),
            "uv0": rng.rand(P, 2).astype(np.float32),
            "valid": rng.rand(P) > 0.5,
            "lam": rng.rand(P, 3, 3).astype(np.float32),
            "R": np.tile(np.eye(3, dtype=np.float32), (512, 1, 1)),
            "t": rng.randn(512, 3).astype(np.float32),
            "pvalid": np.arange(512) < 3}


def _mono_pair():
    from scavislam_tpu.core.lie import PoseRT as JPoseRT
    from scavislam_tpu.models.map_store import PointTable as JPT
    from scavislam_tpu.models.map_store import PoseTable as JPoT
    from scavislam_tpu_torch.core.lie import PoseRT
    from scavislam_tpu_torch.models.mono_frontend import MonoFrontend

    tab = _mono_tables(np.random.RandomState(0), 16384)
    fj = JMono(J_MONO_CAM, prior_idepth=0.3, conv_q_info=20.0,
               prior_weight=0.1)
    ft = MonoFrontend(T_MONO_CAM, prior_idepth=0.3, conv_q_info=20.0,
                      prior_weight=0.1, device=CPU)
    for fe in (fj, ft):
        _random_mono_state(fe, np.random.RandomState(1), tab)
    fj.points = JPT(*(jnp.asarray(tab[k]) for k in (
        "psi", "anchor", "level", "patch", "uv0", "valid")))
    fj.Lam = jnp.asarray(tab["lam"])
    fj.poses = JPoT(jnp.asarray(tab["R"]), jnp.asarray(tab["t"]),
                    jnp.asarray(tab["pvalid"]))
    ft.points = interop.point_table(*(tab[k] for k in (
        "psi", "anchor", "level", "patch", "uv0", "valid")))
    ft.Lam = torch.tensor(tab["lam"])
    ft.poses = interop.pose_table(tab["R"], tab["t"], tab["pvalid"])
    rng = np.random.RandomState(2)
    traj = [(i, rng.randn(3, 3), rng.randn(3)) for i in range(5)]
    fj.trajectory = [(i, JPoseRT(R, t)) for i, R, t in traj]
    ft.trajectory = [(i, PoseRT(R, t)) for i, R, t in traj]
    return fj, ft


def _assert_mono_equal(a, b):
    def arr(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    for f in ("psi", "anchor", "level", "patch", "uv0", "valid"):
        np.testing.assert_array_equal(arr(getattr(a.points, f)),
                                      arr(getattr(b.points, f)))
    np.testing.assert_array_equal(arr(a.Lam), arr(b.Lam))
    for f in ("R", "t", "valid"):
        np.testing.assert_array_equal(arr(getattr(a.poses, f)),
                                      arr(getattr(b.poses, f)))
    for f in ("next_kf", "next_point", "actkey_id", "prior_idepth",
              "conv_q_info", "prior_weight", "frame_id"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.covis == b.covis
    assert a.kf_point_ids.keys() == b.kf_point_ids.keys()
    for k in a.kf_obs:
        np.testing.assert_array_equal(a.kf_obs[k][0], b.kf_obs[k][0])
        np.testing.assert_array_equal(a.kf_obs[k][1], b.kf_obs[k][1])
    for k in a.pose_np:
        np.testing.assert_array_equal(a.pose_np[k][1], b.pose_np[k][1])
    np.testing.assert_array_equal(a._meta_anchor, b._meta_anchor)
    np.testing.assert_array_equal(a._t_cw, b._t_cw)
    assert [f for f, _ in a.trajectory] == [f for f, _ in b.trajectory]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_mono_checkpoint_loads_across_packages(tmp_path, writer):
    # a mono checkpoint written by either package loads in the other with
    # the point, Lambda and pose tables, the host mirrors and the
    # trajectory equal; both writers produce the same JSON
    fj, ft = _mono_pair()
    p = str(tmp_path / "mono.npz")
    if writer == "jax":
        jser.save_mono_system(fj, p)
        loaded = tser.load_mono_system(p, T_MONO_CAM, device=CPU)
        ref = jser.load_mono_system(p, J_MONO_CAM)
    else:
        tser.save_mono_system(ft, p)
        loaded = jser.load_mono_system(p, J_MONO_CAM)
        ref = tser.load_mono_system(p, T_MONO_CAM, device=CPU)
    _assert_mono_equal(loaded, ref)
    q = str(tmp_path / "other.npz")
    (tser.save_mono_system(ft, q) if writer == "jax"
     else jser.save_mono_system(fj, q))
    za, zb = np.load(p), np.load(q)
    assert sorted(za.files) == sorted(zb.files)
    assert str(za["m_meta"]) == str(zb["m_meta"])
    for k in za.files:
        np.testing.assert_array_equal(za[k], zb[k])


def _systems(tmp_path):
    """A JAX and a port SlamSystem holding the same graph, frontend tables,
    host mirrors and place index (seeded), unthreaded."""
    from scavislam_tpu.models.map_store import PointTable as JPT
    from scavislam_tpu.models.map_store import PoseTable as JPoT
    from scavislam_tpu_torch.pipeline.slam_system import SlamSystem

    sj = JSystem(J_CAM, threaded=False, enable_loop_closure=True)
    st = SlamSystem(T_CAM, threaded=False, enable_loop_closure=True,
                    device=CPU)
    gj, gt = _graphs()
    sj.backend.graph, st.backend.graph = gj, gt
    rng = np.random.RandomState(3)
    tab = _mono_tables(rng, 16384)
    sj.frontend.points = JPT(*(jnp.asarray(tab[k]) for k in (
        "psi", "anchor", "level", "patch", "uv0", "valid")))
    sj.frontend.poses = JPoT(jnp.asarray(tab["R"]), jnp.asarray(tab["t"]),
                             jnp.asarray(tab["pvalid"]))
    st.frontend.points = interop.point_table(*(tab[k] for k in (
        "psi", "anchor", "level", "patch", "uv0", "valid")))
    st.frontend.poses = interop.pose_table(tab["R"], tab["t"], tab["pvalid"])
    K = 256
    for s, cls in ((sj, JPlace), (st, Place)):
        _random_mono_state(s.frontend, np.random.RandomState(4), tab)
        r = np.random.RandomState(5)
        for kf in range(3):
            words = r.randint(0, 1024, 80).astype(np.int64)
            padded = (r.rand(K, 128).astype(np.float32),
                      r.rand(K, 3).astype(np.float32), r.rand(K) > 0.4)
            pl = cls(kf, words, padded[0][padded[2]], None,
                     padded[1][padded[2]], set(), padded=padded)
            s.place_recognizer.location_map[kf] = pl
            for w, c in zip(*np.unique(words, return_counts=True)):
                s.place_recognizer.inverted_index[int(w)][kf] = int(c)
                s.place_recognizer.word_doc_count[int(w)] += 1
    return sj, st


def _assert_systems_equal(a, b):
    def arr(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    _assert_graphs_equal(a.backend.graph, b.backend.graph)
    for f in ("psi", "anchor", "level", "patch", "uv0", "valid"):
        np.testing.assert_array_equal(arr(getattr(a.frontend.points, f)),
                                      arr(getattr(b.frontend.points, f)))
    for f in ("R", "t", "valid"):
        np.testing.assert_array_equal(arr(getattr(a.frontend.poses, f)),
                                      arr(getattr(b.frontend.poses, f)))
    assert a.frontend.covis == b.frontend.covis
    assert a.frontend.actkey_id == b.frontend.actkey_id
    np.testing.assert_array_equal(a.frontend._meta_level,
                                  b.frontend._meta_level)
    pa, pb = a.place_recognizer, b.place_recognizer
    assert list(pa.location_map) == list(pb.location_map)
    for k in pa.location_map:
        np.testing.assert_array_equal(pa.location_map[k].words,
                                      pb.location_map[k].words)
        for x, y in zip(pa.location_map[k].padded, pb.location_map[k].padded):
            np.testing.assert_array_equal(x, y)
    assert dict(pa.inverted_index) == dict(pb.inverted_index)
    np.testing.assert_array_equal(arr(pa.vocab), arr(pb.vocab))
    assert a.lost and b.lost
    assert a.backend.prev_kf_id == b.backend.prev_kf_id


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_system_checkpoint_loads_across_packages(tmp_path, writer):
    # a system checkpoint (graph + frontend tables + place index) written by
    # either package loads in the other with everything equal; both load
    # in lost mode
    sj, st = _systems(tmp_path)
    p = str(tmp_path / "sys.npz")
    if writer == "jax":
        jser.save_system(sj, p)
    else:
        tser.save_system(st, p)
    lt = tser.load_system(p, T_CAM, threaded=False, device=CPU)
    lj = jser.load_system(p, J_CAM, threaded=False)
    try:
        _assert_systems_equal(lt, lj)
    finally:
        for s in (sj, st, lt, lj):
            s.shutdown()


class TestSerialization:
    """tests/test_aux.py's TestSerialization, on the port."""

    def test_graph_roundtrip(self, tmp_path):
        calls, _ = make_inputs(6)
        g = build(tsg, calls, T_CAM)
        g.prepare_for_optimization(5)
        p = str(tmp_path / "map.npz")
        tser.save_graph(g, p)
        g2 = tser.load_graph(p, T_CAM, device=CPU)
        _assert_graphs_equal(g, g2)
        # the loaded graph optimizes
        assert g2.prepare_for_optimization(5)
        g2.optimize(num_iters=1)

    def test_tum_trajectory_export(self, tmp_path):
        traj = [(i, SE3.exp(torch.tensor([0.1 * i, 0, 0, 0, 0.05 * i, 0])))
                for i in range(5)]
        p = str(tmp_path / "traj.txt")
        tser.save_trajectory_tum(traj, p)
        rows = np.loadtxt(p)
        assert rows.shape == (5, 8)
        np.testing.assert_allclose(np.linalg.norm(rows[:, 4:8], axis=1), 1.0,
                                   atol=1e-5)


@pytest.mark.slow
class TestMapReuse:
    """tests/test_relocalization.py's TestMapReuse, on the port (its
    256x192 camera and small_cfg; frames from the port's renderer)."""

    def test_save_load_relocalize_continue(self, tmp_path):
        from scavislam_tpu_torch.io.synthetic import SyntheticSequence
        from scavislam_tpu_torch.pipeline.slam_system import SlamSystem
        from scavislam_tpu_torch.utils.config import Config

        cfg = Config()
        cfg = dataclasses.replace(
            cfg, frontend=dataclasses.replace(cfg.frontend, covis_thr=10),
            ui=dataclasses.replace(cfg.ui, parallax_thr=0.08))
        n = 12
        seq = SyntheticSequence(T_CAM, n_frames=n, step=0.02, device=CPU)
        frames = [seq.frame(i) for i in range(n)]
        mapper = SlamSystem(T_CAM, cfg, threaded=False,
                            enable_loop_closure=True, device=CPU)
        mapper.process_first_frame(frames[0])
        for f in frames[1:10]:
            assert mapper.process_frame(dict(f))
        assert len(mapper.place_recognizer.location_map) >= 1
        path = str(tmp_path / "map.npz")
        tser.save_system(mapper, path)
        mapper.shutdown()

        system = tser.load_system(path, T_CAM, cfg, threaded=False,
                                  enable_loop_closure=True, device=CPU)
        assert system.lost
        assert len(system.place_recognizer.location_map) >= 1
        assert len(system.backend.graph.vertices) >= 2
        wake = dict(frames[5])
        wake["frame_id"] = 300
        assert system.process_frame(wake)
        assert not system.lost, "did not localize against the loaded map"
        T_est = dict(system.trajectory)[300]
        err = (T_est @ frames[5]["T_cw_gt"].inverse()).t
        assert np.linalg.norm(err) < 0.25, err
        for i in range(6, 9):
            nxt = dict(frames[i])
            nxt["frame_id"] = 300 + i
            assert system.process_frame(nxt)
        assert not system.lost
        T_last = dict(system.trajectory)[308]
        err2 = (T_last @ frames[8]["T_cw_gt"].inverse()).t
        assert np.linalg.norm(err2) < 0.1, err2
        system.shutdown()

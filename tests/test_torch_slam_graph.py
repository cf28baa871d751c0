"""The port's DWO SlamGraph (scavislam_tpu_torch.models.slam_graph) against
the JAX package's on the same numpy inputs, on the CPU, and the JAX graph
tests (tests/test_slam_graph.py) mirrored on the port.

Both graphs get the same sequence of calls with the same numpy data, so
their host topology (windows, point sets, edges, constraints) must agree
exactly and their solves within the stated tolerances. The JAX sibling-
device and mesh tests become tests that the port raises or warns.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scavislam_tpu.core.camera import StereoCamera as JCam
from scavislam_tpu.models import slam_graph as jsg
from scavislam_tpu_torch import interop
from scavislam_tpu_torch.core.lie import SE3, PoseRT
from scavislam_tpu_torch.models import slam_graph as tsg
from scavislam_tpu_torch.models.backend import Backend
from scavislam_tpu_torch.utils.config import Config

J_CAM = JCam.create(195.0, (127.0, 95.0), (256, 192), 0.12)
T_CAM = interop.camera(np.asarray(J_CAM.focal), np.asarray(J_CAM.pp),
                       J_CAM.size, np.asarray(J_CAM.baseline))
CAPS = (16, 256, 2048, 64)
INNER, OUTER = tsg.INNER, tsg.OUTER


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (tests run one process per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exp(d):
    """numpy (R, t) of SE3.exp of a 6-vector (float64)."""
    T = SE3.exp(torch.as_tensor(d, dtype=torch.float64))
    return T.R.numpy(), T.t.numpy()


def _compose(A, B):
    return A[0] @ B[0], A[0] @ B[1] + A[1]


def gt_pose(i):
    """T_cw of a camera sliding right along x, facing the wall."""
    return np.eye(3), -np.array([0.35 * i, 0.0, 0.0])


def _uvu(T, xyz_w):
    y = xyz_w @ T[0].T + T[1]
    x, yy, z = y[:, 0], y[:, 1], y[:, 2]
    f, (px, py), b = T_CAM.focal, T_CAM.pp, T_CAM.baseline
    return np.stack([x / z * f + px, yy / z * f + py,
                     (x - b) / z * f + px], -1), z


def make_inputs(n_kf=8, perturb=0.0, seed=0):
    """The per-keyframe add_keyframe arguments, as numpy, from a GT
    trajectory: each keyframe observes every visible point, anchored at its
    first observer (tests/test_slam_graph.py's build_graph)."""
    rng = np.random.RandomState(seed)
    n = 60
    xyz_w = np.stack([rng.uniform(-2, 5, n), rng.uniform(-1.5, 1.5, n),
                      np.full(n, 6.0)], -1).astype(np.float32)
    anchored, calls = {}, []
    for i in range(n_kf):
        T_gt = gt_pose(i)
        T_est = (_compose(_exp(rng.randn(6) * perturb), T_gt)
                 if perturb > 0 and i > 0 else T_gt)
        uvu, z = _uvu(T_gt, xyz_w.astype(np.float64))
        vis = ((uvu[:, 0] > 8) & (uvu[:, 0] < 248) & (uvu[:, 1] > 8)
               & (uvu[:, 1] < 184) & (z > 0.5))
        new_points, tracked, strengths = [], [], {}
        for p in np.flatnonzero(vis):
            p = int(p)
            if p not in anchored:
                anchored[p] = i
                xa = T_est[0] @ xyz_w[p] + T_est[1]
                psi = np.array([xa[0] / xa[2], xa[1] / xa[2], 1 / xa[2]])
                new_points.append((p, psi, 0, uvu[p]))
            else:
                tracked.append((p, uvu[p], 0))
                strengths[anchored[p]] = strengths.get(anchored[p], 0) + 1
        calls.append((i, T_est, new_points, tracked, strengths))
    return calls, xyz_w


def build(mod, calls, cam, **kw):
    """Apply the add_keyframe sequence to a graph of module `mod`."""
    if mod is tsg:
        kw.setdefault("device", "cpu")
    g = mod.SlamGraph(cam, covis_thr=5, inner_window_size=4,
                      double_window_size=12, ba_capacity=CAPS, **kw)
    for i, T, new_points, tracked, strengths in calls:
        if i == 0:
            g.add_first_keyframe(0, T)
            v = g.vertices[0]
            for pid, psi, level, uvu in new_points:
                g.points[pid] = mod.GraphPoint(pid, np.asarray(psi), 0, 0,
                                               {0})
                v.feature_table[pid] = (np.asarray(uvu, np.float64), 0)
        else:
            g.add_keyframe(i, T, new_points, tracked, strengths, i - 1)
    return g


def build_graph(n_kf=8, perturb=0.0, seed=0):
    calls, xyz_w = make_inputs(n_kf, perturb, seed)
    return build(tsg, calls, T_CAM), xyz_w


def _jax_T(T):
    from scavislam_tpu.core.lie import SE3 as JSE3
    return JSE3(jnp.asarray(T[0], jnp.float32), jnp.asarray(T[1], jnp.float32))


def _assert_same_topology(gj, gt_, tol=1e-9):
    """Same windows, point sets, edges and neighbor strengths; constraints
    equal to `tol` (1e-9 before any solve; after a solve they are computed
    from f32-solved poses, and agree to the solve's 1e-4)."""
    assert list(gt_.double_window.items()) == list(gj.double_window.items())
    assert gt_.active_points == gj.active_points
    assert gt_.outer_points == gj.outer_points
    assert list(gt_.edges) == list(gj.edges)
    for k, ej in gj.edges.items():
        et = gt_.edges[k]
        assert (et.id1, et.id2, et.strength, et.edge_type) == \
            (ej.id1, ej.id2, ej.strength, ej.edge_type)
        assert et.is_marginalized() == ej.is_marginalized(), k
        if ej.is_marginalized():
            np.testing.assert_allclose(et.R_1_from_2, ej.R_1_from_2,
                                       atol=tol)
            np.testing.assert_allclose(et.t_1_from_2, ej.t_1_from_2,
                                       atol=tol)
            np.testing.assert_allclose(et.Lambda, ej.Lambda, rtol=10 * tol)
    for k in gj.vertices:
        assert gt_.vertices[k].neighbor_strengths == \
            gj.vertices[k].neighbor_strengths


def test_same_sequence_same_graph_as_jax():
    # add, prepare, optimize, slide the window, register, loop: identical
    # windows, point sets, edges and constraints at every step; poses
    # within 1e-4 and psis within 1e-4 after each solve
    calls, xyz_w = make_inputs(12, perturb=0.01, seed=3)
    gj = build(jsg, calls, J_CAM)
    gt_ = build(tsg, calls, T_CAM)
    _assert_same_topology(gj, gt_)
    tol = [1e-9]

    def solve_both(root, loop_id=-1):
        assert gj.prepare_for_optimization(root, loop_id) == \
            gt_.prepare_for_optimization(root, loop_id)
        _assert_same_topology(gj, gt_, tol[0])
        tol[0] = 1e-4
        gj.optimize(num_iters=2)
        gt_.optimize(num_iters=2)
        for k in gj.vertices:
            np.testing.assert_allclose(gt_.vertices[k].R, gj.vertices[k].R,
                                       atol=1e-4)
            np.testing.assert_allclose(gt_.vertices[k].t, gj.vertices[k].t,
                                       atol=1e-4)
        for p in gj.points:
            np.testing.assert_allclose(gt_.points[p].psi, gj.points[p].psi,
                                       atol=1e-4)
        for key in ("chi2_init", "chi2_final"):
            assert abs(gt_.stats[key] - gj.stats[key]) <= \
                1e-4 * max(1.0, abs(gj.stats[key]))

    solve_both(7)
    solve_both(11)
    # a metric registration of 11 against 2 (points anchored at 2)
    tracked = [(pid, np.asarray(_uvu(gt_pose(11), xyz_w[pid:pid + 1]
                                     .astype(np.float64))[0][0]), 0)
               for pid, p in gj.points.items() if p.anchor_id == 2][:8]
    gj.register_keyframes(11, _jax_T(gt_pose(11)), {2: 8}, tracked)
    gt_.register_keyframes(11, gt_pose(11), {2: 8}, tracked)
    _assert_same_topology(gj, gt_, 1e-4)
    solve_both(11)
    # an appearance loop 0 <-> 11
    gj.add_loop_closure(0, 11, _jax_T(gt_pose(11)), tracked)
    gt_.add_loop_closure(0, 11, gt_pose(11), tracked)
    _assert_same_topology(gj, gt_, 1e-4)
    solve_both(0, loop_id=11)
    for k in (2, 5):
        Tj = PoseRT.from_any(gj.compute_absolute_pose(k))
        Tt = gt_.compute_absolute_pose(k)
        np.testing.assert_allclose(Tt.t, Tj.t, atol=1e-4)
    assert gt_.frames_in_neighborhood(11, 6) == \
        gj.frames_in_neighborhood(11, 6)


def test_solve_packed_on_one_shared_buffer():
    # the packed problem the port's optimize uploads, fed as ONE numpy
    # buffer to both frameworks' _solve_packed: R, t, psi within 1e-4,
    # chi2 within 1e-4 relative
    g, _ = build_graph(8, perturb=0.01, seed=5)
    assert g.prepare_for_optimization(7)
    g.optimize(num_iters=2)
    cam_params, buf, caps = g.last_problem
    buf = buf.numpy().copy()
    out_j = jsg._solve_packed(cam_params, jnp.asarray(buf), caps, 2, 3.0)
    out_t = tsg._solve_packed(cam_params, torch.as_tensor(buf), caps, 2, 3.0)
    for a, b in zip(out_t[:3], out_j[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    for a, b in zip(out_t[3][:2], out_j[3][:2]):
        assert abs(float(a) - float(b)) <= 1e-4 * max(1.0, abs(float(b)))
    prob_j, aperm_j = jsg._unpack_problem(jnp.asarray(buf), caps)
    prob_t, aperm_t = tsg._unpack_problem(torch.as_tensor(buf), caps)
    np.testing.assert_array_equal(aperm_t.numpy(), np.asarray(aperm_j))
    for name in prob_j._fields:
        np.testing.assert_array_equal(getattr(prob_t, name).numpy(),
                                      np.asarray(getattr(prob_j, name)))


def test_load_graph_state_then_optimize_side_by_side():
    # a JAX graph's host state carried into a port graph (interop): the same
    # topology, then one optimize on each gives every pose and psi within
    # 1e-4 (by id: the BA slots follow the containers' order)
    calls, _ = make_inputs(10, perturb=0.01, seed=9)
    gj = build(jsg, calls, J_CAM)
    assert gj.prepare_for_optimization(9)
    gt_ = interop.load_graph_state(
        tsg.SlamGraph(T_CAM, covis_thr=5, inner_window_size=4,
                      double_window_size=12, ba_capacity=CAPS, device="cpu"),
        gj.vertices, gj.points, gj.edges, gj.double_window,
        gj.active_points, gj.outer_points)
    _assert_same_topology(gj, gt_)
    gj.optimize(num_iters=2)
    gt_.optimize(num_iters=2)
    for k in gj.vertices:
        np.testing.assert_allclose(gt_.vertices[k].t, gj.vertices[k].t,
                                   atol=1e-4)
        np.testing.assert_allclose(gt_.vertices[k].R, gj.vertices[k].R,
                                   atol=1e-4)
    for p in gj.points:
        np.testing.assert_allclose(gt_.points[p].psi, gj.points[p].psi,
                                   atol=1e-4)


# -- tests/test_slam_graph.py, mirrored on the port ------------------------- #

class TestWindows:
    def test_double_window_types(self):
        g, _ = build_graph(8)
        assert g.prepare_for_optimization(7)
        inner = [k for k, v in g.double_window.items() if v == INNER]
        outer = [k for k, v in g.double_window.items() if v == OUTER]
        assert 7 in inner
        assert len(inner) <= 4
        assert len(inner) + len(outer) <= 12

    def test_active_points_anchored_in_window(self):
        g, _ = build_graph(8)
        g.prepare_for_optimization(7)
        for pid in g.active_points:
            assert g.points[pid].anchor_id in g.double_window

    def test_inner_edges_unmarginalized(self):
        g, _ = build_graph(8)
        g.prepare_for_optimization(7)
        inner = {k for k, v in g.double_window.items() if v == INNER}
        for (a, b), e in g.edges.items():
            if a in inner and b in inner:
                assert not e.is_marginalized(), (a, b)

    def test_marginalize_on_window_slide(self):
        g, _ = build_graph(10)
        g.prepare_for_optimization(5)
        g.prepare_for_optimization(9)
        inner_after = {k for k, v in g.double_window.items() if v == INNER}
        for (a, b), e in g.edges.items():
            if not (a in inner_after and b in inner_after):
                assert e.is_marginalized(), (a, b)


def _rel_ate(g):
    T_root = g.vertices[7].T
    T_root_gt = PoseRT(*gt_pose(7))
    errs = []
    for i in g.double_window:
        rel_est = g.vertices[i].T @ T_root.inverse()
        rel_gt = PoseRT(*gt_pose(i)) @ T_root_gt.inverse()
        errs.append(np.linalg.norm((rel_est @ rel_gt.inverse()).t))
    return float(np.mean(errs))


class TestOptimize:
    def test_ba_improves_perturbed_poses(self):
        g, _ = build_graph(8)
        assert g.prepare_for_optimization(7)
        rng = np.random.RandomState(1)
        for i in range(1, 8):
            g.vertices[i].set_T(_compose(_exp(rng.randn(6) * 0.01),
                                         (g.vertices[i].R, g.vertices[i].t)))
        assert g.prepare_for_optimization(7)
        before = _rel_ate(g)
        g.optimize(num_iters=4)
        after = _rel_ate(g)
        assert g.stats["chi2_final"] < g.stats["chi2_init"]
        assert after < before
        assert after < 5e-3, (before, after)

    def test_exact_graph_stays_put(self):
        g, _ = build_graph(6)
        g.prepare_for_optimization(5)
        before = {i: g.vertices[i].t.copy() for i in g.double_window}
        g.optimize(num_iters=2)
        for i, t0 in before.items():
            np.testing.assert_allclose(g.vertices[i].t, t0, atol=1e-3)


class TestWindowOverflow:
    def test_strongest_first_selection_at_p_overflow(self):
        g, _ = build_graph(10)
        assert g.prepare_for_optimization(9)
        window_ids = list(g.double_window.keys())
        inner = {k for k, v in g.double_window.items() if v == INNER}
        P = len(inner) + 2
        assert len(window_ids) > P
        sel = g._select_window_overflow(window_ids, P)
        assert len(sel) == P and sel[0] == 9
        assert inner <= set(sel)

        def strength(k):
            ns = g.vertices[k].neighbor_strengths
            return max((ns.get(i, 0) for i in inner), default=0)
        kept = [k for k in sel if k not in inner]
        dropped = [k for k in window_ids if k not in sel]
        if kept and dropped:
            assert min(map(strength, kept)) >= max(map(strength, dropped))

    def test_optimize_runs_at_p_overflow(self):
        g, _ = build_graph(10)
        assert g.prepare_for_optimization(9)
        g._caps = (6,) + tuple(g._caps[1:])
        assert len(g.double_window) > 6
        rng = np.random.RandomState(2)
        for i in range(1, 10):
            g.vertices[i].set_T(_compose(_exp(rng.randn(6) * 0.005),
                                         (g.vertices[i].R, g.vertices[i].t)))
        g.optimize(num_iters=3)
        assert g.stats["chi2_final"] < g.stats["chi2_init"]


class TestAsyncSolve:
    def test_async_matches_sync_bitwise(self):
        def run(sync):
            g, _ = build_graph(8, perturb=0.01, seed=7)
            assert g.prepare_for_optimization(7)
            g.optimize(num_iters=3, sync=sync)
            if not sync:
                assert g.solve_pending()
                assert g.finish_pending() is None
                assert not g.solve_pending()
            return g

        ga, gb = run(True), run(False)
        for k in ga.vertices:
            np.testing.assert_array_equal(ga.vertices[k].R, gb.vertices[k].R)
            np.testing.assert_array_equal(ga.vertices[k].t, gb.vertices[k].t)
        for p in ga.points:
            np.testing.assert_array_equal(ga.points[p].psi, gb.points[p].psi)
        assert gb.stats["chi2_final"] == ga.stats["chi2_final"]

    def test_solve_log_records_solve_time_not_adoption_gap(self):
        # on the CPU the solve runs inside optimize(); its time is logged,
        # not the idle gap before adoption
        import time as _time

        g, _ = build_graph(8, perturb=0.01)
        assert g.prepare_for_optimization(7)
        t0 = _time.perf_counter()
        g.optimize(num_iters=2, sync=False)
        dispatch_ms = (_time.perf_counter() - t0) * 1e3
        assert g.solve_ready()
        _time.sleep(0.25)
        assert g.adopt_pending()
        assert len(g.solve_log) == 1
        n_verts, ms = g.solve_log[0]
        assert n_verts == 8
        assert 0.0 < ms <= dispatch_ms + 1.0
        assert g.stats["calc_time"] * 1e3 == ms
        assert g.prepare_for_optimization(7)
        g.optimize(num_iters=2, sync=True)
        assert len(g.solve_log) == 2

    def test_prepare_fail_reason_recorded(self):
        cam = interop.camera(100.0, (32.0, 24.0), (64, 48), 0.1)
        g = tsg.SlamGraph(cam, covis_thr=5, device="cpu")
        g.add_first_keyframe(0)
        assert not g.prepare_for_optimization(0)
        assert g.last_prepare_fail == "single_vertex_map"
        g2, _ = build_graph(8)
        assert g2.prepare_for_optimization(7)
        assert g2.last_prepare_fail == ""

    def test_mutating_methods_force_adoption(self):
        g, _ = build_graph(8, perturb=0.01)
        assert g.prepare_for_optimization(7)
        g.optimize(num_iters=2, sync=False)
        assert g.solve_pending()
        assert g.prepare_for_optimization(7)
        assert not g.solve_pending()
        assert g.stats["chi2_final"] < g.stats["chi2_init"]

    def test_late_adoption_applies_delta_correction(self):
        g, _ = build_graph(8, perturb=0.01)
        assert g.prepare_for_optimization(7)
        pre = {k: (g.vertices[k].R.copy(), g.vertices[k].t.copy())
               for k in g.vertices}
        psi_pre = {p: g.points[p].psi.copy() for p in g.points}
        g.optimize(num_iters=2, sync=True)
        solved = {k: (g.vertices[k].R.copy(), g.vertices[k].t.copy())
                  for k in g.vertices}
        for k, (R, t) in pre.items():
            g.vertices[k].R, g.vertices[k].t = R.copy(), t.copy()
        for p, ps in psi_pre.items():
            g.points[p].psi = ps.copy()
        victim = [k for k in g.double_window if k != 7][0]
        g.optimize(num_iters=2, sync=False)
        d = np.asarray([0.02, -0.01, 0.03])
        g.vertices[victim].t = g.vertices[victim].t + d
        g.finish_pending()
        for k in g.double_window:
            if k != victim:
                np.testing.assert_array_equal(g.vertices[k].R, solved[k][0])
        R_pre, t_pre = pre[victim]
        R_new, t_new = solved[victim]
        Rc = R_new @ R_pre.T
        expect_t = Rc @ (t_pre + d) + (t_new - Rc @ t_pre)
        np.testing.assert_allclose(g.vertices[victim].t, expect_t, atol=1e-9)
        np.testing.assert_allclose(g.vertices[victim].R, R_new, atol=1e-7)


class TestQueries:
    def test_absolute_pose_outside_window(self):
        g, _ = build_graph(16)
        g.prepare_for_optimization(15)
        outside = [i for i in g.vertices if i not in g.double_window]
        assert outside
        T = g.compute_absolute_pose(outside[0])
        err = (T @ PoseRT(*gt_pose(outside[0])).inverse()).t
        assert np.linalg.norm(err) < 0.05

    def test_frames_in_neighborhood(self):
        g, _ = build_graph(8)
        nbrs = g.frames_in_neighborhood(7, 4)
        assert nbrs[0] == 7 and len(nbrs) == 4


class TestLoopClosure:
    def test_loop_reduces_drift(self):
        g, xyz_w = build_graph(8)
        drift = _exp(np.asarray([0.3, 0.1, 0.0, 0.0, 0.05, 0.0]))
        for i in range(4, 8):
            g.vertices[i].set_T(_compose(drift,
                                         (g.vertices[i].R, g.vertices[i].t)))
        uvu, _ = _uvu(gt_pose(7), xyz_w[:10].astype(np.float64))
        tracked = [(pid, uvu[pid], 0) for pid in range(10)]
        g.add_loop_closure(0, 7, gt_pose(7), tracked)
        assert g.prepare_for_optimization(0, loop_id=7)
        g.optimize(num_iters=6)
        err7 = np.linalg.norm(
            (g.vertices[7].T @ PoseRT(*gt_pose(7)).inverse()).t)
        assert err7 < 0.15, err7


class TestSolvePlacement:
    def test_solve_mesh_raises(self):
        """A mesh whose "sp" size does not divide the observation capacity
        is refused at the solve (the twin's O % n == 0 assertion)."""
        from scavislam_tpu_torch.parallel.mesh import make_mesh

        g, _ = build_graph(6)
        g.solve_mesh = make_mesh(3, dp=1, devices=["cpu"] * 3)
        assert g.prepare_for_optimization(5)
        with pytest.raises(ValueError, match="obs capacity"):
            g.optimize(num_iters=2)

    @pytest.mark.parametrize("n", [2, 8])
    def test_solve_mesh_matches_single_device(self, n):
        """graph.solve_mesh over n CPU shards: one packed upload, one
        observation chunk per shard; the adopted solve agrees with the
        single-device one up to f32 summation order: chi2 within 1e-5
        relative, points within 1e-5, poses within 5e-5 (measured 2.1e-5
        at n = 2 and 1.5e-5 at n = 8 after 3 LM rounds on this perturbed
        graph; one shard is bit-equal)."""
        from scavislam_tpu_torch.parallel.mesh import make_mesh

        graphs = []
        for mesh in (None, make_mesh(n, dp=1, devices=["cpu"] * n)):
            g, _ = build_graph(8, perturb=0.01, seed=2)
            g.solve_mesh = mesh
            assert g.prepare_for_optimization(7)
            g.optimize(num_iters=3)
            graphs.append(g)
        g1, gm = graphs
        assert gm.stats["chi2_final"] < gm.stats["chi2_init"]
        assert gm.stats["chi2_final"] == pytest.approx(
            g1.stats["chi2_final"], rel=1e-5)
        for k, v in g1.vertices.items():
            np.testing.assert_allclose(gm.vertices[k].t, v.t, atol=5e-5)
            np.testing.assert_allclose(gm.vertices[k].R, v.R, atol=5e-5)
        for pid, p in g1.points.items():
            np.testing.assert_allclose(gm.points[pid].psi, p.psi, atol=1e-5)

    def test_backend_resolves_index_and_mesh(self, capsys):
        # an index past the cards present, or a mesh wider than them, falls
        # back to the default device with a warning, as the twin does
        cfg = Config()
        for graph_kw in ({"solve_device": 99}, {"solve_mesh": 4}):
            c = dataclasses.replace(
                cfg, graph=dataclasses.replace(cfg.graph, **graph_kw))
            be = Backend(T_CAM, c, device="cpu")
            assert be.graph.solve_device is None
            assert be.graph.solve_mesh is None
        assert "solve_mesh=4" in capsys.readouterr().err

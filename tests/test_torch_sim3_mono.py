"""The port's Sim3 machinery of the mono mode: the twin's
tests/test_sim3_mono.py cases mirrored (Sim3 RANSAC, the scale-drift-aware
Sim3 pose graph, the batched point filter), and the pose graph against the
JAX package's on one graph (CPU)."""

import jax.numpy as jnp
import numpy as np
import torch

from scavislam_tpu.core.lie import Sim3 as JSim3
from scavislam_tpu.models.sim3_graph import (
    optimize_sim3_pose_graph as j_optimize,
)
from scavislam_tpu_torch.core.lie import SO3, Sim3
from scavislam_tpu_torch.models.pose_optimizer import filter_points_info
from scavislam_tpu_torch.models.sim3_graph import optimize_sim3_pose_graph
from scavislam_tpu_torch.ops.ransac import draw_hypotheses, ransac_sim3

CAM_PARAMS = (195.0, 127.0, 95.0, 0.12)


def _stack(sims):
    return Sim3(torch.stack([S.R for S in sims]),
                torch.stack([S.t for S in sims]),
                torch.stack([S.s.reshape(()) for S in sims]))


def _one(R, t, s=1.0):
    return Sim3(torch.as_tensor(np.asarray(R), dtype=torch.float32),
                torch.as_tensor(np.asarray(t), dtype=torch.float32),
                torch.tensor(float(s)))


def _drift_loop(n=12, drift=1.04):
    """The twin's drift loop: ground truth on a circle (node-from-world,
    unit scale), drifted odometry edges k -> k+1, the exact loop edge
    n-1 -> 0, and the drifted odometry integrated as the initial nodes.
    Returns (nodes, edge_i, edge_j, edges) as port Sim3s."""
    gt = []
    for k in range(n):
        a = 2 * np.pi * k / n
        R = SO3.exp(torch.tensor([0.0, a, 0.0])).R
        c = torch.tensor([np.cos(a), 0.0, np.sin(a)], dtype=torch.float32)
        gt.append(_one(R, -(R @ c)))
    meas = []
    for k in range(n):
        S = gt[k] @ gt[(k + 1) % n].inverse()
        meas.append(Sim3(S.R, S.t, S.s * drift))
    meas[-1] = gt[n - 1] @ gt[0].inverse()
    est = [gt[0]]
    for k in range(n - 1):
        est.append(meas[k].inverse() @ est[-1])
    ei = np.arange(n, dtype=np.int32)
    ej = (ei + 1) % n
    return _stack(est), ei, ej, _stack(meas)


class TestSim3Ransac:
    def test_recovers_similarity_with_outliers(self):
        rng = np.random.RandomState(3)
        n = 80
        xyz_a = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                          rng.uniform(3, 8, n)], -1).astype(np.float32)
        R_gt = SO3.exp(torch.tensor([0.05, -0.1, 0.02])).R.numpy()
        s_gt, t_gt = 1.35, np.array([0.3, -0.1, 0.5], np.float32)
        xyz_b = (s_gt * xyz_a @ R_gt.T + t_gt).astype(np.float32)
        n_out = n // 4
        xyz_b[:n_out] += rng.uniform(0.5, 2.0, (n_out, 3))
        gen = torch.Generator()
        gen.manual_seed(0)
        s, R, t, inl, cnt = ransac_sim3(
            draw_hypotheses(n, 256, gen), torch.tensor(xyz_a),
            torch.tensor(xyz_b), torch.ones(n, dtype=torch.bool), CAM_PARAMS,
            inlier_thr=2.0)
        assert int(cnt) > 0.8 * (n - n_out)
        assert abs(float(s) - s_gt) < 0.02
        np.testing.assert_allclose(R.numpy(), R_gt, atol=2e-2)
        np.testing.assert_allclose(t.numpy(), t_gt, atol=5e-2)
        assert inl.numpy()[:n_out].mean() < 0.3


class TestSim3PoseGraph:
    def test_scale_drift_loop_closure(self):
        n = 12
        nodes, ei, ej, edges = _drift_loop(n)
        assert float(nodes.s[-1]) < 0.7  # drift visible before
        out, hist = optimize_sim3_pose_graph(
            nodes, ei, ej, edges, torch.ones(n, dtype=torch.bool), iters=12)
        # the cycle is inconsistent by construction: the optimum spreads
        # ln(1.04^11)^2 over 12 edges
        assert hist[-1] < hist[0] * 0.05, hist
        assert abs(hist[-1] - np.log(1.04**11) ** 2 / 12) < 3e-3, hist[-1]
        s = out.s.numpy()
        assert s.max() / s.min() < 1.25, s
        np.testing.assert_allclose(out.t[0].numpy(), nodes.t[0].numpy(),
                                   atol=1e-4)

    def test_noise_free_graph_is_fixed_point(self):
        n = 5
        rng = np.random.RandomState(0)
        nodes_list = [Sim3.identity()]
        for _ in range(n - 1):
            xi = torch.tensor(rng.randn(7) * 0.2, dtype=torch.float32)
            nodes_list.append(nodes_list[-1] @ Sim3.exp(xi))
        nodes = _stack(nodes_list)
        ei = np.arange(n - 1, dtype=np.int32)
        ej = ei + 1
        edges = _stack([nodes_list[i] @ nodes_list[i + 1].inverse()
                        for i in range(n - 1)])
        out, hist = optimize_sim3_pose_graph(
            nodes, ei, ej, edges, torch.ones(n - 1, dtype=torch.bool),
            iters=3)
        assert hist[-1] < 1e-8
        np.testing.assert_allclose(out.t.numpy(), nodes.t.numpy(), atol=1e-4)

    def test_matches_jax_and_stays_f32(self):
        # the drift loop through both packages' optimizers from the same
        # f32 nodes and edges: nodes and chi2 history within 1e-4; every
        # output f32 (torch's forward AD must not promote to f64)
        n = 12
        nodes, ei, ej, edges = _drift_loop(n)
        J = lambda S: JSim3(jnp.asarray(S.R.numpy()), jnp.asarray(S.t.numpy()),
                            jnp.asarray(S.s.numpy()))
        oj, hj = j_optimize(J(nodes), ei, ej, J(edges), jnp.ones(n, bool),
                            iters=12)
        ot, ht = optimize_sim3_pose_graph(
            nodes, ei, ej, edges, torch.ones(n, dtype=torch.bool), iters=12)
        for a, b in ((ot.R, oj.R), (ot.t, oj.t), (ot.s, oj.s)):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
        np.testing.assert_allclose(ht, hj, rtol=1e-4, atol=1e-6)
        # and a fixed node stays put when the mask names another node
        fixed = torch.zeros(n, dtype=torch.bool)
        fixed[3] = True
        o3, _ = optimize_sim3_pose_graph(nodes, ei, ej, edges,
                                         torch.ones(n, dtype=torch.bool),
                                         fixed_mask=fixed, iters=2)
        assert torch.equal(o3.t[3], nodes.t[3])


class TestMonoPointFilter:
    CAM = (200.0, 128.0, 96.0)

    def _project(self, R_ca, t_ca, xyz_a):
        y = xyz_a @ np.asarray(R_ca).T + t_ca
        f, px, py = self.CAM
        return np.stack([y[:, 0] / y[:, 2] * f + px,
                         y[:, 1] / y[:, 2] * f + py], -1)

    def test_depth_recovered_with_parallax(self):
        rng = np.random.RandomState(1)
        n = 32
        xyz = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.8, 0.8, n),
                        rng.uniform(3, 8, n)], -1)
        psi_true = np.stack([xyz[:, 0] / xyz[:, 2], xyz[:, 1] / xyz[:, 2],
                             1.0 / xyz[:, 2]], -1).astype(np.float32)
        psi0 = psi_true.copy()
        psi0[:, 2] = 0.5
        Lam0 = np.zeros((n, 3, 3), np.float32)
        Lam0[:, 0, 0] = Lam0[:, 1, 1] = 1e4
        R_ca = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
        t_ca = np.tile(np.array([-0.5, 0.0, 0.0], np.float32), (n, 1))
        obs = self._project(np.eye(3), t_ca[0], xyz).astype(np.float32)
        out = filter_points_info(
            self.CAM, torch.tensor(R_ca), torch.tensor(t_ca),
            torch.tensor(psi0), torch.tensor(Lam0), torch.tensor(obs),
            torch.ones(n, dtype=torch.bool), iters=8)
        np.testing.assert_allclose(out.psi[:, 2].numpy(), psi_true[:, 2],
                                   rtol=0.02)
        dL = out.Lambda.numpy() - Lam0
        assert (dL[:, 2, 2] > 0).all()
        assert np.linalg.eigvalsh(dL).min() > -1e-2

    def test_pure_rotation_leaves_depth_unobserved(self):
        n = 8
        rng = np.random.RandomState(2)
        xyz = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.8, 0.8, n),
                        rng.uniform(3, 8, n)], -1)
        psi_true = np.stack([xyz[:, 0] / xyz[:, 2], xyz[:, 1] / xyz[:, 2],
                             1.0 / xyz[:, 2]], -1).astype(np.float32)
        R = SO3.exp(torch.tensor([0.0, 0.05, 0.0])).R.numpy()
        R_ca = np.tile(R, (n, 1, 1))
        t_ca = np.zeros((n, 3), np.float32)
        obs = self._project(R, np.zeros(3), xyz).astype(np.float32)
        out = filter_points_info(
            self.CAM, torch.tensor(R_ca), torch.tensor(t_ca),
            torch.tensor(psi_true), torch.zeros((n, 3, 3)),
            torch.tensor(obs), torch.ones(n, dtype=torch.bool), iters=5)
        dL = out.Lambda.numpy()
        assert abs(dL[:, 2, 2]).max() < 1e-4 * abs(dL[:, 0, 0]).max()
        np.testing.assert_allclose(out.psi.numpy(), psi_true, atol=1e-3)

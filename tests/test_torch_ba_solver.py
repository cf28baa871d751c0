"""The port's Schur-complement BA solver (scavislam_tpu_torch.models.
ba_solver) against the JAX package's on the same numpy problems, on the
CPU, and the JAX solver tests (tests/test_ba_solver.py) mirrored on the
port.

Problems are made with numpy from a seed: keyframes sliding along x in
front of a wall, every keyframe observing every point, poses and points
perturbed; the parity problems also carry 0.5 px observation noise, so
chi2 stays well above f32 round-off at the optimum and a relative chi2
tolerance means something.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scavislam_tpu.models import ba_solver as jba
from scavislam_tpu_torch import interop
from scavislam_tpu_torch.core.lie import SE3
from scavislam_tpu_torch.models import ba_solver as tba

FOCAL, PPX, PPY, BASELINE = (float(np.float32(x)) for x in
                             (195.0, 127.0, 95.0, 0.12))
CAM_PARAMS = (FOCAL, PPX, PPY, BASELINE)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (tests run one process per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exp_so3(w):
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + K
    return (np.eye(3) + np.sin(th) / th * K
            + (1 - np.cos(th)) / th ** 2 * K @ K)


def _perturb(R, t, rng, scale):
    d = rng.randn(6) * scale
    Rd = _exp_so3(d[3:])
    return Rd @ R, Rd @ t + d[:3]


def _uvu(xyz):
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    return np.stack([x / z * FOCAL + PPX, y / z * FOCAL + PPY,
                     (x - BASELINE) / z * FOCAL + PPX], -1)


def _empty_fields(P, L, O, E):
    """Writable numpy fields of an empty BAProblem."""
    return {k: np.array(getattr(jba.BAProblem.empty(P, L, O, E), k))
            for k in jba.BAProblem._fields}


def gt_problem(seed=11, n_poses=6, n_points=96, caps=(8, 128, 1024, 16),
               noise_pose=0.02, noise_psi=0.02, noise_px=0.0, n_fixed=2,
               outliers=0.0):
    """(numpy fields of a BAProblem, GT poses [(R, t)], GT psi (n, 3))."""
    rng = np.random.RandomState(seed)
    P, L, O, E = caps
    gt = [(np.eye(3), -np.array([0.25 * i, 0.0, 0.1 * i]))
          for i in range(n_poses)]
    xyz_w = np.stack([rng.uniform(-1, 3, n_points),
                      rng.uniform(-1, 1, n_points),
                      rng.uniform(3.0, 9.0, n_points)], -1)
    anchors = np.arange(n_points) % n_poses
    psi_gt = np.zeros((n_points, 3))
    for p in range(n_points):
        Ra, ta = gt[anchors[p]]
        xa = Ra @ xyz_w[p] + ta
        psi_gt[p] = [xa[0] / xa[2], xa[1] / xa[2], 1 / xa[2]]
    f = _empty_fields(P, L, O, E)
    for i, (R, t) in enumerate(gt):
        if i >= n_fixed:
            R, t = _perturb(R, t, rng, noise_pose)
        f["R"][i], f["t"][i] = R, t
        f["pose_valid"][i] = True
        f["pose_fixed"][i] = i < n_fixed
    f["psi"][:n_points] = psi_gt + rng.randn(n_points, 3) * noise_psi
    f["point_valid"][:n_points] = True
    f["anchor_slot"][:n_points] = anchors
    o = 0
    for i, (R, t) in enumerate(gt):
        uvu = _uvu(xyz_w @ R.T + t)
        f["obs_pose"][o:o + n_points] = i
        f["obs_point"][o:o + n_points] = np.arange(n_points)
        f["obs_uvu"][o:o + n_points] = uvu
        o += n_points
    f["obs_valid"][:o] = True
    f["obs_uvu"][:o] += rng.randn(o, 3) * noise_px
    if outliers:
        bad = rng.uniform(size=o) < outliers
        f["obs_uvu"][:o][bad] += rng.randn(int(bad.sum()), 3) * 25.0
    return f, gt, psi_gt


def _jax_prob(f):
    return jba.BAProblem(**{k: jnp.asarray(v) for k, v in f.items()})


def _sorted_with_perm(f):
    """Obs sorted by (pose, point) and the anchor permutation, the way
    slam_graph.optimize packs a problem."""
    f = dict(f)
    order = np.lexsort((f["obs_point"], f["obs_pose"]))
    for k in ("obs_pose", "obs_point", "obs_uvu", "obs_weight", "obs_valid"):
        f[k] = f[k][order]
    aperm = np.lexsort((f["obs_point"], f["anchor_slot"][f["obs_point"]]))
    return f, aperm.astype(np.int32)


def _pose_err(R, t, gt_Rt):
    Rg, tg = gt_Rt
    T = SE3(torch.as_tensor(np.asarray(R) @ Rg.T, dtype=torch.float32),
            torch.as_tensor(np.asarray(t) - np.asarray(R) @ Rg.T @ tg,
                            dtype=torch.float32))
    return float(T.log().abs().max())


@pytest.mark.parametrize("with_perm", [False, True])
def test_solve_ba_matches_jax(with_perm):
    # R, t within 1e-4 absolute, psi within 1e-4, chi2 within 1e-4 relative
    f, _, _ = gt_problem(noise_px=0.5)
    f, aperm = _sorted_with_perm(f)
    ap_j = jnp.asarray(aperm) if with_perm else None
    ap_t = torch.as_tensor(aperm) if with_perm else None
    Rj, tj, pj, sj = jba.solve_ba(CAM_PARAMS, _jax_prob(f), iters=2,
                                  anchor_perm=ap_j)
    Rt, tt, pt, st = tba.solve_ba(CAM_PARAMS, interop.ba_problem(**f),
                                  iters=2, anchor_perm=ap_t)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-4)
    for a, b in ((st.chi2_initial, sj.chi2_initial),
                 (st.chi2_final, sj.chi2_final)):
        assert abs(float(a) - float(b)) <= 1e-4 * abs(float(b))
    assert int(st.num_obs) == int(sj.num_obs)


def test_normal_equations_match_jax():
    # every block within 1e-4 of the largest entry of its kind (f32 sums
    # over 576 observations in a different order)
    f, _, _ = gt_problem(noise_px=0.5)
    jp, tp = _jax_prob(f), interop.ba_problem(**f)
    out_j = jba._build_normal_equations(CAM_PARAMS, jp, jp.R, jp.t, jp.psi,
                                        3.0)
    out_t = tba._build_normal_equations(CAM_PARAMS, tp, tp.R, tp.t, tp.psi,
                                        3.0)
    for name, a, b in zip(("Hcc", "Wcp", "Hpp", "g_c", "g_p"), out_t, out_j):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        scale = max(float(np.abs(b).max()), 1e-6)
        assert float(np.abs(a.numpy() - b).max()) <= 1e-4 * scale, name


def test_inv3x3_matches_jax():
    rng = np.random.RandomState(3)
    A = rng.randn(64, 3, 3).astype(np.float32)
    M = (A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3)).astype(np.float32)
    M[0] = 0.0  # singular: the regularized closed form stays finite
    inv_j = np.asarray(jba._inv3x3(jnp.asarray(M)))
    inv_t = tba._inv3x3(torch.as_tensor(M)).numpy()
    np.testing.assert_allclose(inv_t, inv_j, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(inv_t[1:] @ M[1:],
                               np.broadcast_to(np.eye(3), (63, 3, 3)),
                               atol=1e-3)


def test_nan_guard_failed_factorization():
    # nothing observed and lambda0 = 0: S is all zeros on the free poses,
    # the factorization fails; both solvers leave every pose unchanged
    f, _, _ = gt_problem()
    f["obs_valid"][:] = False
    jR, jt, _, js = jba.solve_ba(CAM_PARAMS, _jax_prob(f), iters=1,
                                 lambda0=0.0)
    tR, tt, _, ts = tba.solve_ba(CAM_PARAMS, interop.ba_problem(**f),
                                 iters=1, lambda0=0.0)
    for R, t in ((np.asarray(jR), np.asarray(jt)), (tR.numpy(), tt.numpy())):
        assert np.isfinite(R).all() and np.isfinite(t).all()
        np.testing.assert_array_equal(R, f["R"])
        np.testing.assert_array_equal(t, f["t"])
    assert float(ts.chi2_final) == float(js.chi2_final) == 0.0


def test_sharded_axis_raises():
    """An observation axis that does not split evenly over the shard group
    is refused (the twin's O % n == 0 assertion)."""
    from scavislam_tpu_torch.parallel.mesh import make_mesh

    f, _, _ = gt_problem()  # O = 1024
    mesh = make_mesh(3, dp=1, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="obs capacity 1024"):
        tba.solve_ba(CAM_PARAMS, interop.ba_problem(**f),
                     sp_axis=mesh.axis("sp"))


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_axis_matches_unsharded(n):
    """sp_axis over n CPU shards: the shards' partial normal equations sum
    to the unsharded system, so the solve agrees within 1e-5 (summation
    order only) on a perturbed problem with edges and mono rows."""
    from scavislam_tpu_torch.parallel.mesh import make_mesh

    f, gt, _ = gt_problem(seed=3, noise_px=0.5)
    for e, (i, j) in enumerate(((2, 3), (3, 5))):  # replicated edges
        f["edge_i"][e], f["edge_j"][e] = i, j
        f["edge_R"][e] = np.eye(3)
        f["edge_t"][e] = gt[j][1] - gt[i][1]
        f["edge_info"][e] = 100.0 * np.eye(6)
        f["edge_valid"][e] = True
    rng = np.random.RandomState(4)
    disp = torch.as_tensor((rng.rand(f["obs_valid"].shape[0]) > 0.3)
                           .astype(np.float32) * 0.111)
    prob = interop.ba_problem(**f)
    axis = make_mesh(n, dp=1, devices=["cpu"] * n).axis("sp")
    for di in (None, disp):
        ref = tba.solve_ba(CAM_PARAMS, prob, iters=3, disp_info=di)
        out = tba.solve_ba(CAM_PARAMS, prob, iters=3, disp_info=di,
                           sp_axis=axis)
        for a, b in zip(out[:3], ref[:3]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
        assert float(out[3].chi2_final) == pytest.approx(
            float(ref[3].chi2_final), rel=1e-5)
        assert int(out[3].num_obs) == int(ref[3].num_obs)
        assert float(ref[3].chi2_final) < float(ref[3].chi2_initial)


# -- tests/test_ba_solver.py, mirrored on the port -------------------------- #

class TestInnerWindowBA:
    def test_chi2_decreases(self):
        f, _, _ = gt_problem()
        _, _, _, st = tba.solve_ba(CAM_PARAMS, interop.ba_problem(**f),
                                   iters=2)
        assert float(st.chi2_final) < float(st.chi2_initial) * 0.1

    def test_recovers_poses_and_points(self):
        f, gt, psi_gt = gt_problem()
        R, t, psi, _ = tba.solve_ba(CAM_PARAMS, interop.ba_problem(**f),
                                    iters=6, lambda0=1.0)
        for i in range(2, len(gt)):
            assert _pose_err(R[i].numpy(), t[i].numpy(), gt[i]) < 2e-3, i
        perr = np.abs(psi[:len(psi_gt)].numpy() - psi_gt)
        assert float(np.median(perr)) < 1e-3

    def test_fixed_poses_unchanged(self):
        f, gt, _ = gt_problem()
        R, t, _, _ = tba.solve_ba(CAM_PARAMS, interop.ba_problem(**f),
                                  iters=2)
        for i in range(2):
            np.testing.assert_allclose(R[i].numpy(), gt[i][0], atol=1e-7)
            np.testing.assert_allclose(t[i].numpy(), gt[i][1], atol=1e-7)

    def test_huber_tolerates_outlier_obs(self):
        # 5% gross outliers in random directions: the Huber kernel keeps the
        # solution near GT where the quadratic cost does not
        f, gt, _ = gt_problem(noise_pose=0.004, noise_psi=0.004,
                              outliers=0.05)
        prob = interop.ba_problem(**f)
        R, t, _, _ = tba.solve_ba(CAM_PARAMS, prob, iters=2, huber=3.0)
        R2, t2, _, _ = tba.solve_ba(CAM_PARAMS, prob, iters=2, huber=1e9)
        e_h = [_pose_err(R[i].numpy(), t[i].numpy(), gt[i])
               for i in range(2, len(gt))]
        e_p = [_pose_err(R2[i].numpy(), t2[i].numpy(), gt[i])
               for i in range(2, len(gt))]
        assert max(e_h) < 0.1, e_h
        assert max(e_h) < 0.3 * max(e_p), (e_h, e_p)


class TestPoseGraph:
    def test_chain_relaxation(self):
        """Pose-graph only: chain + loop constraint pulls the chain back."""
        P, L, O, E = 8, 16, 16, 16
        f = _empty_fields(P, L, O, E)
        n = 6
        gt = [SE3.exp(torch.tensor([0.3 * i, 0.0, 0.0, 0.0, 0.2 * i, 0.0]))
              for i in range(n)]
        rng = np.random.RandomState(2)
        for i in range(n):
            T = gt[i] if i == 0 else SE3.exp(
                torch.as_tensor(rng.randn(6) * 0.05, dtype=torch.float32)
            ) @ gt[i]
            f["R"][i], f["t"][i] = T.R.numpy(), T.t.numpy()
            f["pose_valid"][i] = True
        f["pose_fixed"][0] = True
        pairs = [(i, i + 1) for i in range(n - 1)] + [(0, n - 1)]
        for e, (i, j) in enumerate(pairs):
            T_ji = gt[j] @ gt[i].inverse()  # constraint = T_j_from_i
            f["edge_i"][e], f["edge_j"][e] = i, j
            f["edge_R"][e], f["edge_t"][e] = T_ji.R.numpy(), T_ji.t.numpy()
            f["edge_info"][e] = np.eye(6) * 100.0
            f["edge_valid"][e] = True
        R, t, _, st = tba.solve_ba(CAM_PARAMS, interop.ba_problem(**f),
                                   iters=6, lambda0=1.0)
        assert float(st.chi2_final) < float(st.chi2_initial) * 1e-3
        for i in range(n):
            err = (SE3(R[i], t[i]) @ gt[i].inverse()).log()
            assert float(err.abs().max()) < 1e-3, (i, err)


class TestSortedScatterPath:
    def test_anchor_perm_matches_unsorted(self):
        """The anchor permutation (the twin's sorted-scatter hint) gives the
        solution of the unsorted path on a problem packed the way
        slam_graph.optimize packs it."""
        f, _, _ = gt_problem(noise_px=0.5)
        rng = np.random.RandomState(5)
        shuffle = rng.permutation(len(f["obs_pose"]))
        for k in ("obs_pose", "obs_point", "obs_uvu", "obs_weight",
                  "obs_valid"):
            f[k] = f[k][shuffle]
        fs, aperm = _sorted_with_perm(f)
        prob = interop.ba_problem(**fs)
        R1, t1, psi1, s1 = tba.solve_ba(CAM_PARAMS, prob, iters=2)
        R2, t2, psi2, s2 = tba.solve_ba(CAM_PARAMS, prob, iters=2,
                                        anchor_perm=torch.as_tensor(aperm))
        np.testing.assert_allclose(t1.numpy(), t2.numpy(), atol=2e-5)
        np.testing.assert_allclose(psi1.numpy(), psi2.numpy(), atol=2e-5)
        assert abs(float(s1.chi2_final) - float(s2.chi2_final)) <= (
            1e-3 * max(1.0, float(s1.chi2_final)))

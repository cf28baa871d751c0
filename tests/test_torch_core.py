"""The port's core library against the JAX package's, on the CPU: the cases
of tests/test_core_lie.py, tests/test_core_camera.py and
tests/test_core_jacobians.py on the same numpy inputs, plus the Sim3 group.

Each case holds the port to the twin's own bar and to the twin's numbers.
The analytic Jacobians are held against ``torch.func.jacfwd`` of the port's
prediction functions, as the twin holds its own against ``jax.jacfwd``. The
cases tests/test_torch_modules.py already holds (SE3 exp, log and
compose-inverse against the twin) are not repeated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from scavislam_tpu.core import lie as jlie
from scavislam_tpu.core import transforms as jtf
from scavislam_tpu.core.camera import StereoCamera as JCam
from scavislam_tpu_torch.core import lie as tlie
from scavislam_tpu_torch.core import transforms as ttf
from scavislam_tpu_torch.core.camera import StereoCamera as TCam

J_CAM = JCam.create(389.96, (254.0, 182.0), (512, 384), 0.12)
T_CAM = TCam.create(389.96, (254.0, 182.0), (512, 384), 0.12)


def _t(x):
    return torch.as_tensor(np.array(x, np.float32))


def _n(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rng(seed):
    return np.random.default_rng(seed)


def _xi(seed, scale=1.0, n=None):
    return (_rng(seed).normal(size=(6,) if n is None else (n, 6))
            * scale).astype(np.float32)


def _point(seed):
    rng = _rng(seed)
    xy = rng.normal(size=2) * 0.5
    z = 2.0 + rng.random() * 5.0
    return np.array([xy[0] * z, xy[1] * z, z], np.float32)


def _se3_pair(xi):
    """The same pose in both packages: exp on the twin, the port takes its
    matrices (so pose rounding is not part of a comparison)."""
    T = jlie.SE3.exp(jnp.asarray(xi))
    return T, tlie.SE3(_t(T.R), _t(T.t))


# -- core.lie: SO3 -----------------------------------------------------------------

class TestSO3:
    def test_exp_log_roundtrip(self):
        # the twin's bar, 1e-4; and the port's exp within 2e-6 of the twin's
        om = _rng(0).normal(size=(64, 3)).astype(np.float32) * 1.5
        om *= np.minimum(1.0, 2.9 / np.linalg.norm(om, axis=-1, keepdims=True))
        Rt = tlie.SO3.exp(_t(om))
        np.testing.assert_allclose(_n(Rt.log()), om, atol=1e-4)
        np.testing.assert_allclose(_n(Rt.R), np.asarray(
            jlie.SO3.exp(jnp.asarray(om)).R), atol=2e-6)

    def test_exp_at_zero(self):
        np.testing.assert_allclose(_n(tlie.SO3.exp(torch.zeros(3)).R),
                                   np.eye(3), atol=1e-7)
        np.testing.assert_array_equal(_n(tlie.SO3.identity((2,)).R),
                                      np.asarray(jlie.SO3.identity((2,)).R))

    def test_log_near_pi(self):
        axis = np.array([0.3, -0.5, 0.81], np.float32)
        axis /= np.linalg.norm(axis)
        for angle in [3.05, 3.14, np.pi - 1e-3]:
            w = (axis * angle).astype(np.float32)
            Rj = np.asarray(jlie.SO3.exp(jnp.asarray(w)).R)
            back = tlie.SO3(_t(Rj)).log()
            np.testing.assert_allclose(_n(tlie.SO3.exp(back).R), Rj,
                                       atol=5e-4)
            # the twin's near-pi branch returns the same tangent (2e-4: the
            # axis is a square root of a difference near zero)
            np.testing.assert_allclose(
                _n(back), np.asarray(jlie.SO3(jnp.asarray(Rj)).log()),
                atol=2e-4)

    def test_orthogonality(self):
        R = _n(tlie.SO3.exp(_t(_rng(1).normal(size=3))).R)
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)
        assert abs(np.linalg.det(R) - 1.0) < 1e-6

    def test_exp_grad_finite_at_zero(self):
        g = jacfwd(lambda w: tlie.SO3.exp(w).R)(torch.zeros(3))
        assert torch.isfinite(g).all()
        gj = jax.jacfwd(lambda w: jlie.SO3.exp(w).R)(jnp.zeros(3))
        np.testing.assert_allclose(_n(g), np.asarray(gj), atol=1e-7)


# -- core.lie: SE3 -----------------------------------------------------------------

class TestSE3:
    def test_identity_and_inverse(self):
        Tj, Tt = _se3_pair(_xi(0, 0.8))
        I = Tt @ Tt.inverse()
        np.testing.assert_allclose(_n(I.R), np.eye(3), atol=1e-6)
        np.testing.assert_allclose(_n(I.t), np.zeros(3), atol=1e-6)
        E = tlie.SE3.identity((3,))
        Ej = jlie.SE3.identity((3,))
        np.testing.assert_array_equal(_n(E.R), np.asarray(Ej.R))
        np.testing.assert_array_equal(_n(E.t), np.asarray(Ej.t))

    def test_composition_matches_matrix(self):
        (Aj, A), (Bj, B) = _se3_pair(_xi(1)), _se3_pair(_xi(2))
        np.testing.assert_allclose(_n((A @ B).matrix()),
                                   _n(A.matrix()) @ _n(B.matrix()), atol=1e-5)
        np.testing.assert_array_equal(_n(A.matrix()), np.asarray(Aj.matrix()))
        back = tlie.SE3.from_matrix(A.matrix())
        assert torch.equal(back.R, A.R) and torch.equal(back.t, A.t)

    def test_apply_matches_matrix(self):
        Tj, T = _se3_pair(_xi(3))
        pts = _rng(3).normal(size=(10, 3)).astype(np.float32)
        hom = np.concatenate([pts, np.ones((10, 1), np.float32)], axis=-1)
        expect = (_n(T.matrix()) @ hom.T).T[:, :3]
        np.testing.assert_allclose(_n(T.apply(_t(pts))), expect, atol=1e-5)

    def test_adjoint_definition(self):
        # the twin's bar (1e-5), and the adjoint within 1e-6 of the twin's
        Tj, T = _se3_pair(_xi(4, 0.7))
        xi = _t(_xi(5, 0.05))
        lhs = (T @ tlie.SE3.exp(xi) @ T.inverse()).log()
        np.testing.assert_allclose(_n(lhs), _n(T.adjoint() @ xi), atol=1e-5)
        np.testing.assert_allclose(_n(T.adjoint()), np.asarray(Tj.adjoint()),
                                   atol=1e-6)

    def test_retract_left_multiplicative(self):
        Tj, T = _se3_pair(_xi(6))
        d = _xi(7, 0.1)
        Tr = T.retract(_t(d))
        np.testing.assert_allclose(_n(Tr.matrix()),
                                   _n((tlie.SE3.exp(_t(d)) @ T).matrix()),
                                   atol=1e-6)
        np.testing.assert_allclose(_n(Tr.matrix()), np.asarray(
            Tj.retract(jnp.asarray(d)).matrix()), atol=1e-5)

    def test_exp_batched_stack_slice(self):
        # the twin's jit case: batched exp/log round trip (1e-4); stack and
        # slice return the members
        xis = _xi(8, 0.5, 8)
        Ts = tlie.SE3.exp(_t(xis))
        np.testing.assert_allclose(_n(Ts.log()), xis, atol=1e-4)
        S = tlie.SE3.stack([Ts.slice(i) for i in range(8)])
        assert torch.equal(S.R, Ts.R) and torch.equal(S.t, Ts.t)


class TestBracket:
    def test_ad_matches_bracket(self):
        a, b = _t(_xi(9)), _t(_xi(10))
        np.testing.assert_allclose(_n(tlie.ad_se3(a) @ b),
                                   _n(tlie.lie_bracket_se3(a, b)), atol=1e-6)

    def test_hat_vee(self):
        w = _t(_rng(11).normal(size=3))
        np.testing.assert_allclose(_n(tlie.vee(tlie.hat(w))), _n(w), atol=1e-7)


# -- core.lie: Sim3 ----------------------------------------------------------------

def _sim3_tangents():
    """Tangents across Sim3.exp's branches: sigma below and above 1e-4,
    theta^2 below and above 1e-6, and zero."""
    xi = _xi(12, 0.6, 6)
    xi = np.concatenate([xi, np.zeros((6, 1), np.float32)], axis=-1)
    xi[:, 6] = [0.3, -0.2, 5e-5, 0.0, 0.4, -1e-5]
    xi[2, 3:6] *= 1e-4  # theta^2 < 1e-6
    xi[3, 3:6] = 0.0
    xi[4, 3:6] *= 1e-4
    return np.concatenate([xi, np.zeros((1, 7), np.float32)])


class TestSim3:
    def test_exp_matches_jax(self):
        # within 2e-6 of the twin on every branch (f32 transcendentals)
        xi = _sim3_tangents()
        Sj = jlie.Sim3.exp(jnp.asarray(xi))
        St = tlie.Sim3.exp(_t(xi))
        for a, b in zip(St, Sj):
            np.testing.assert_allclose(_n(a), np.asarray(b), atol=2e-6)

    def test_log_roundtrip(self):
        # the tangent back within 1e-4, and within 1e-5 of the twin's log
        xi = _sim3_tangents()
        S = tlie.Sim3.exp(_t(xi))
        np.testing.assert_allclose(_n(S.log()), xi, atol=1e-4)
        Sj = jlie.Sim3(*(jnp.asarray(_n(x)) for x in S))
        np.testing.assert_allclose(_n(S.log()), np.asarray(Sj.log()),
                                   atol=1e-5)

    def test_group_ops_match_jax(self):
        # compose, apply and inverse: products, within 1e-5 of the twin's
        xi = _sim3_tangents()
        A = tlie.Sim3.exp(_t(xi))
        B = tlie.Sim3.exp(_t(xi[::-1].copy()))
        Aj = jlie.Sim3(*(jnp.asarray(_n(x)) for x in A))
        Bj = jlie.Sim3(*(jnp.asarray(_n(x)) for x in B))
        pts = _rng(13).normal(size=(7, 3)).astype(np.float32)
        for a, b in zip(A @ B.inverse(), Aj @ Bj.inverse()):
            np.testing.assert_allclose(_n(a), np.asarray(b), atol=1e-5)
        np.testing.assert_allclose(_n(A.apply(_t(pts))),
                                   np.asarray(Aj.apply(jnp.asarray(pts))),
                                   atol=1e-5)
        I = A @ A.inverse()
        np.testing.assert_allclose(_n(I.R), np.broadcast_to(np.eye(3), (7, 3, 3)),
                                   atol=1e-6)
        np.testing.assert_allclose(_n(I.t), 0.0, atol=1e-5)
        np.testing.assert_allclose(_n(I.s), 1.0, atol=1e-6)
        E = tlie.Sim3.identity((2,))
        for a, b in zip(E, jlie.Sim3.identity((2,))):
            np.testing.assert_array_equal(_n(a), np.asarray(b))

    def test_exp_grad_finite_at_zero(self):
        # forward and reverse derivatives through the where-guarded series
        # stay finite at the zero tangent
        # (a batch of one: see _exp1)
        z = torch.zeros(1, 7)
        g = jacfwd(lambda x: torch.cat([tlie.Sim3.exp(x).t,
                                        tlie.Sim3.exp(x).s[:, None]], -1))(z)
        assert torch.isfinite(g).all()
        z.requires_grad_(True)
        S = tlie.Sim3.exp(z)
        (S.t.sum() + S.s + S.R.sum()).backward()
        assert torch.isfinite(z.grad).all()


# -- core.camera -------------------------------------------------------------------

class TestCamera:
    def test_map_unmap_roundtrip(self):
        rng = _rng(1)
        xyz = np.stack([rng.normal(size=32) * 2.0, rng.normal(size=32) * 2.0,
                        2.0 + rng.random(32) * 8.0], -1).astype(np.float32)
        back = T_CAM.unmap_uvu(T_CAM.map_uvu(_t(xyz)))
        np.testing.assert_allclose(_n(back), xyz, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(_n(T_CAM.map_uvu(_t(xyz))),
                                   np.asarray(J_CAM.map_uvu(jnp.asarray(xyz))),
                                   rtol=1e-6)

    def test_disparity_positive_for_positive_depth(self):
        uvu = T_CAM.map_uvu(_t([0.5, -0.3, 4.0]))
        assert uvu[0] > uvu[2]

    def test_q_matrix_consistent_with_unmap(self):
        xyz = _t([0.7, 0.2, 3.0])
        uvu = T_CAM.map_uvu(xyz)
        d = uvu[0] - uvu[2]
        h = T_CAM.Q() @ torch.stack([uvu[0], uvu[1], d, torch.ones(())])
        np.testing.assert_allclose(_n(h[:3] / h[3]), _n(xyz), rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_array_equal(_n(T_CAM.Q()), np.asarray(J_CAM.Q()))

    def test_depth_to_disp_consistent(self):
        uvu = T_CAM.map_uvu(_t([0.0, 0.0, 4.0]))
        d = T_CAM.depth_to_disp(_t(4.0))
        np.testing.assert_allclose(_n(d), _n(uvu[0] - uvu[2]), rtol=1e-5)
        np.testing.assert_array_equal(
            _n(d), np.asarray(J_CAM.depth_to_disp(jnp.float32(4.0))))

    def test_scale_level_disparity_invariant(self):
        xyz = _t([0.4, -0.2, 5.0])
        u0 = T_CAM.map_uvu(xyz)
        for level in (1, 2):
            ul = T_CAM.scale_level(level).map_uvu(xyz)
            np.testing.assert_allclose(_n(ul[0] - ul[2]), _n(u0[0] - u0[2]),
                                       rtol=1e-5)

    def test_scale_level_projection_halves(self):
        xyz = _t([0.4, -0.2, 5.0])
        uv0 = T_CAM.mono.project(xyz)
        uv1 = T_CAM.scale_level(1).mono.project(xyz)
        np.testing.assert_allclose(_n(uv1), _n((uv0 + 0.5) / 2.0 - 0.5),
                                   atol=1e-4)
        lc, lj = T_CAM.mono, J_CAM.mono
        assert (lc.width, lc.height) == (lj.width, lj.height) == (512, 384)
        np.testing.assert_array_equal(_n(lc.intrinsics()),
                                      np.asarray(lj.intrinsics()))
        uv = _t([[100.0, 50.0], [300.5, 200.25]])
        np.testing.assert_allclose(_n(lc.map(lc.unmap(uv))), _n(uv),
                                   atol=1e-4)
        np.testing.assert_allclose(_n(lc.unmap(uv)), np.asarray(
            lj.unmap(jnp.asarray(_n(uv)))), rtol=1e-6)

    def test_uv_disp_to_xyz(self):
        xyz = _t([0.7, 0.2, 3.0])
        uvu = T_CAM.map_uvu(xyz)
        got = T_CAM.uv_disp_to_xyz(uvu[0], uvu[1], uvu[0] - uvu[2])
        np.testing.assert_allclose(_n(got), _n(xyz), rtol=1e-4, atol=1e-3)
        gj = J_CAM.uv_disp_to_xyz(*(jnp.asarray(_n(x)) for x in
                                    (uvu[0], uvu[1], uvu[0] - uvu[2])))
        np.testing.assert_allclose(_n(got), np.asarray(gj), rtol=1e-6)


# -- core.transforms ---------------------------------------------------------------

def _jac_close(J, Jnum, Jj, atol, rtol=0.0):
    """The port's analytic Jacobian J against its jacfwd (the twin's
    tolerance) and against the twin's analytic one (1e-4 relative: the
    same expressions in f32)."""
    np.testing.assert_allclose(_n(J), _n(Jnum), atol=atol, rtol=rtol)
    np.testing.assert_allclose(_n(J), np.asarray(Jj), rtol=1e-4, atol=1e-4)


def _zeros6():
    return torch.zeros(6)


def _exp1(xi):
    """SE3.exp of one tangent through a batch of one. Forward-mode AD in
    this PyTorch (2.13) promotes the tangent of a 0-dim float32 tensor
    times a Python float to float64, and exp's angle is 0-dim for a single
    tangent; with a batch axis it is not."""
    return tlie.SE3.exp(xi[None]).slice(0)


class TestElementary:
    def test_d_proj_d_y(self):
        xyz = _point(7)
        J = ttf.d_proj_d_y(T_CAM.focal, _t(xyz))
        Jnum = jacfwd(T_CAM.mono.project)(_t(xyz))
        _jac_close(J, Jnum, jtf.d_proj_d_y(J_CAM.focal, jnp.asarray(xyz)),
                   1e-2, 1e-2)

    def test_d_stereoproj_d_y(self):
        xyz = _point(7)
        J = ttf.d_stereoproj_d_y(T_CAM.focal, T_CAM.baseline, _t(xyz))
        Jnum = jacfwd(T_CAM.map_uvu)(_t(xyz))
        _jac_close(J, Jnum, jtf.d_stereoproj_d_y(
            J_CAM.focal, J_CAM.baseline, jnp.asarray(xyz)), 1e-2, 1e-2)

    def test_d_expy_d_y(self):
        y = _point(7)
        J = ttf.d_expy_d_y(_t(y))
        Jnum = jacfwd(lambda xi: _exp1(xi).apply(_t(y)))(_zeros6())
        _jac_close(J, Jnum, jtf.d_expy_d_y(jnp.asarray(y)), 1e-4)

    def test_d_Tinvpsi_d_psi(self):
        Tj, T = _se3_pair(_xi(20, 0.4))
        psi = ttf.psi_from_xyz(_t(_point(21)))
        J = ttf.d_Tinvpsi_d_psi(T, psi)
        Jnum = jacfwd(lambda p: T.apply(ttf.invert_depth(p)))(psi)
        _jac_close(J, Jnum, jtf.d_Tinvpsi_d_psi(Tj, jnp.asarray(_n(psi))),
                   1e-2, 1e-2)

    def test_invert_depth_involution(self):
        xyz = _t(_point(7))
        np.testing.assert_allclose(
            _n(ttf.invert_depth(ttf.psi_from_xyz(xyz))), _n(xyz), atol=1e-4)
        np.testing.assert_allclose(
            _n(ttf.psi_from_xyz(xyz)),
            np.asarray(jtf.psi_from_xyz(jnp.asarray(_n(xyz)))), rtol=1e-6)


def _pose_point(seed):
    """A pose and a world point in front of its camera, in both packages."""
    Tj, T = _se3_pair(_xi(seed, 0.4))
    xyz_w = T.inverse().apply(_t(_point(seed + 1)))
    return Tj, T, xyz_w


class TestWorldPointModel:
    def test_frame_jac(self):
        Tj, T, x = _pose_point(30)
        J = ttf.frame_jac_uvu_world(T_CAM, T, x)
        Jnum = jacfwd(lambda xi: ttf.predict_uvu_world(T_CAM, _exp1(xi) @ T,
                                                       x))(_zeros6())
        _jac_close(J, Jnum, jtf.frame_jac_uvu_world(
            J_CAM, Tj, jnp.asarray(_n(x))), 5e-2, 1e-2)

    def test_point_jac(self):
        Tj, T, x = _pose_point(32)
        J = ttf.point_jac_uvu_world(T_CAM, T, x)
        Jnum = jacfwd(lambda p: ttf.predict_uvu_world(T_CAM, T, p))(x)
        _jac_close(J, Jnum, jtf.point_jac_uvu_world(
            J_CAM, Tj, jnp.asarray(_n(x))), 5e-2, 1e-2)

    def test_batched(self):
        Ts = tlie.SE3.exp(_t(_xi(34, 0.4, 16)))
        pts = torch.stack([Ts.slice(i).inverse().apply(_t(_point(40 + i)))
                           for i in range(16)])
        J = ttf.frame_jac_uvu_world(T_CAM, Ts, pts)
        assert J.shape == (16, 3, 6) and torch.isfinite(J).all()
        J1 = ttf.frame_jac_uvu_world(T_CAM, Ts.slice(5), pts[5])
        np.testing.assert_allclose(_n(J[5]), _n(J1), rtol=1e-6)


class TestAnchoredModel:
    @pytest.fixture
    def setup(self):
        Aj, A = _se3_pair(_xi(50, 0.4))
        Cj, C = _se3_pair(_xi(51, 0.05))
        T, Tj = C @ A, Cj @ Aj
        psi = ttf.psi_from_xyz(_t(_point(52)))
        return Tj, T, Aj, A, psi

    def test_prediction_matches_world_model(self, setup):
        Tj, T, Aj, A, psi = setup
        xyz_w = A.inverse().apply(ttf.invert_depth(psi))
        np.testing.assert_allclose(
            _n(ttf.predict_anchored_uvu(T_CAM, T, A, psi)),
            _n(ttf.predict_uvu_world(T_CAM, T, xyz_w)), atol=1e-3)

    def test_all_three_jacobians(self, setup):
        Tj, T, Aj, A, psi = setup
        Jf, Ja, Jp = ttf.anchored_jacs(T_CAM, T, A, psi)
        Jf_num = jacfwd(lambda xi: ttf.predict_anchored_uvu(
            T_CAM, _exp1(xi) @ T, A, psi))(_zeros6())
        Ja_num = jacfwd(lambda xi: ttf.predict_anchored_uvu(
            T_CAM, T, _exp1(xi) @ A, psi))(_zeros6())
        Jp_num = jacfwd(lambda p: ttf.predict_anchored_uvu(
            T_CAM, T, A, p))(psi)
        Jjs = jtf.anchored_jacs(J_CAM, Tj, Aj, jnp.asarray(_n(psi)))
        for J, Jn, Jj in zip((Jf, Ja, Jp), (Jf_num, Ja_num, Jp_num), Jjs):
            _jac_close(J, Jn, Jj, 5e-2, 1e-2)


class TestRelativePoseEdge:
    def test_error_zero_at_consistency(self):
        (_, T1), (_, T2) = _se3_pair(_xi(60, 0.4)), _se3_pair(_xi(61, 0.4))
        err = ttf.relative_pose_error(T2 @ T1.inverse(), T1, T2)
        np.testing.assert_allclose(_n(err), np.zeros(6), atol=1e-5)

    def test_bch_jacobians_close_to_autodiff(self):
        T1j, T1 = _se3_pair(_xi(62, 0.4))
        T2 = tlie.SE3.exp(_t(_xi(63, 0.05))) @ T1
        T21 = (T2 @ T1.inverse()).retract(_t(_xi(64, 0.02)))
        d, J1, J2 = ttf.relative_pose_jacobians(T21, T1, T2)
        # the error's log runs on a batch of one too (see _exp1)
        B21, B1, B2 = (tlie.SE3(T.R[None], T.t[None]) for T in (T21, T1, T2))
        E = tlie.SE3.exp
        J1n = jacfwd(lambda xi: ttf.relative_pose_error(
            B21, E(xi[None]) @ B1, B2)[0])(_zeros6())
        J2n = jacfwd(lambda xi: ttf.relative_pose_error(
            B21, B1, E(xi[None]) @ B2)[0])(_zeros6())
        dj, J1j, J2j = jtf.relative_pose_jacobians(
            *(jlie.SE3(jnp.asarray(_n(T.R)), jnp.asarray(_n(T.t)))
              for T in (T21, T1, T2)))
        np.testing.assert_allclose(_n(d), np.asarray(dj), atol=1e-5)
        _jac_close(J1, J1n, J1j, 5e-4)
        _jac_close(J2, J2n, J2j, 5e-4)


class TestMonoModels:
    def test_frame_jac_uv_world(self):
        Tj, T = _se3_pair(_xi(70, 0.3))
        x = _t(_point(71))
        J = ttf.frame_jac_uv_world(T_CAM, T, x)
        Jn = jacfwd(lambda e: ttf.predict_uv_world(
            T_CAM, _exp1(e) @ T, x))(_zeros6())
        _jac_close(J, Jn, jtf.frame_jac_uv_world(J_CAM, Tj,
                                                 jnp.asarray(_n(x))),
                   1e-2, 1e-2)
        np.testing.assert_allclose(
            _n(ttf.predict_uv_world(T_CAM.mono, T, x)),
            np.asarray(jtf.predict_uv_world(J_CAM.mono, Tj,
                                            jnp.asarray(_n(x)))), rtol=1e-5)

    def test_uv_psi_jacs(self):
        Tj, T = _se3_pair(_xi(72, 0.3))
        psi = ttf.psi_from_xyz(_t(_point(73)))
        Jf, Jp = ttf.uv_psi_jacs(T_CAM, T, psi)
        Jfn = jacfwd(lambda e: ttf.predict_uv_psi(
            T_CAM, _exp1(e) @ T, psi))(_zeros6())
        Jpn = jacfwd(lambda p: ttf.predict_uv_psi(T_CAM, T, p))(psi)
        Jjs = jtf.uv_psi_jacs(J_CAM, Tj, jnp.asarray(_n(psi)))
        _jac_close(Jf, Jfn, Jjs[0], 1e-2, 1e-2)
        _jac_close(Jp, Jpn, Jjs[1], 1e-2, 1e-2)

    def test_uvu_psi_jacs(self):
        Tj, T = _se3_pair(_xi(74, 0.3))
        psi = ttf.psi_from_xyz(_t(_point(75)))
        Jf, Jp = ttf.uvu_psi_jacs(T_CAM, T, psi)
        Jfn = jacfwd(lambda e: ttf.predict_uvu_psi(
            T_CAM, _exp1(e) @ T, psi))(_zeros6())
        Jpn = jacfwd(lambda p: ttf.predict_uvu_psi(T_CAM, T, p))(psi)
        Jjs = jtf.uvu_psi_jacs(J_CAM, Tj, jnp.asarray(_n(psi)))
        _jac_close(Jf, Jfn, Jjs[0], 1e-2, 1e-2)
        _jac_close(Jp, Jpn, Jjs[1], 1e-2, 1e-2)

    def test_uvu_from_uvu_roundtrip(self):
        x = _t(_point(76))
        uvu = T_CAM.map_uvu(x)
        np.testing.assert_allclose(
            _n(ttf.predict_uvu_from_uvu(T_CAM, tlie.SE3.identity(), uvu)),
            _n(uvu), atol=1e-3)
        Tj, T = _se3_pair(_xi(77, 0.3))
        np.testing.assert_allclose(
            _n(ttf.predict_uvu_from_uvu(T_CAM, T, uvu)),
            _n(T_CAM.map_uvu(T.apply(x))), atol=1e-2)

    def test_anchored_uv_jacs(self):
        (Tj, T), (Aj, A) = _se3_pair(_xi(78, 0.3)), _se3_pair(_xi(79, 0.3))
        psi = ttf.psi_from_xyz(_t(_point(80)))
        Js = ttf.anchored_uv_jacs(T_CAM, T, A, psi)
        Jns = (jacfwd(lambda e: ttf.predict_anchored_uv(
                   T_CAM, _exp1(e) @ T, A, psi))(_zeros6()),
               jacfwd(lambda e: ttf.predict_anchored_uv(
                   T_CAM, T, _exp1(e) @ A, psi))(_zeros6()),
               jacfwd(lambda p: ttf.predict_anchored_uv(T_CAM, T, A, p))(psi))
        Jjs = jtf.anchored_uv_jacs(J_CAM, Tj, Aj, jnp.asarray(_n(psi)))
        for J, Jn, Jj in zip(Js, Jns, Jjs):
            _jac_close(J, Jn, Jj, 1e-2, 1e-2)


def test_homography_matches_jax():
    # H = R + t n^T / (n . p): the twin's formula, within 1e-6
    Tj, T = _se3_pair(_xi(90, 0.3))
    n = np.array([0.1, -0.2, 0.97], np.float32)
    p = np.array([0.3, 0.1, 4.0], np.float32)
    H = ttf.homography_c2_from_c1(T, _t(n), _t(p))
    np.testing.assert_allclose(_n(H), np.asarray(jtf.homography_c2_from_c1(
        Tj, jnp.asarray(n), jnp.asarray(p))), atol=1e-6)
    # a point on the plane maps as the rigid motion does (normalized)
    x2 = _n(T.apply(_t(p)))
    h = _n(H) @ (p / p[2])
    np.testing.assert_allclose(h[:2] / h[2], x2[:2] / x2[2], atol=1e-5)

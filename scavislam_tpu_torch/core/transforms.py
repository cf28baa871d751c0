"""Projection helpers and analytic Jacobians (port of
scavislam_tpu.core.transforms).

Conventions:
- inverse-depth point ``psi = (x/z, y/z, 1/z)`` in its anchor frame;
  ``invert_depth(psi)`` recovers the 3-D point;
- pose updates are left-multiplicative ``T <- exp(delta) * T`` with tangent
  layout ``[upsilon, omega]`` (see core.lie);
- stereo observation ``uvu = (u_left, v, u_right)``;
- a Jacobian is that of the PREDICTION (not of the residual obs - pred).

Every analytic Jacobian here is held against ``torch.func.jacfwd`` of its
prediction function in the tests. ``cam`` is a ``LinearCamera`` or a
``StereoCamera`` (host-float intrinsics).
"""

from __future__ import annotations

import torch

from scavislam_tpu_torch.core.camera import StereoCamera, pp_tensor
from scavislam_tpu_torch.core.lie import SE3, ad_se3, hat


# -- point parametrizations ------------------------------------------------

def project2d(xyz: torch.Tensor) -> torch.Tensor:
    return xyz[..., :2] / xyz[..., 2:3]


def unproject2d(uv: torch.Tensor) -> torch.Tensor:
    return torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)


def invert_depth(psi: torch.Tensor) -> torch.Tensor:
    """(u, v, q) -> xyz = (u/q, v/q, 1/q). An involution."""
    return unproject2d(psi[..., :2]) / psi[..., 2:3]


def psi_from_xyz(xyz: torch.Tensor) -> torch.Tensor:
    """xyz -> (x/z, y/z, 1/z). Inverse of :func:`invert_depth`."""
    return torch.stack([xyz[..., 0] / xyz[..., 2], xyz[..., 1] / xyz[..., 2],
                        1.0 / xyz[..., 2]], dim=-1)


def _pixels(cam, xy: torch.Tensor) -> torch.Tensor:
    return xy * cam.focal + pp_tensor(cam, xy)


# -- elementary Jacobians ---------------------------------------------------

def d_proj_d_y(focal, xyz: torch.Tensor) -> torch.Tensor:
    """d(pinhole uv)/d(camera-frame xyz): (..., 2, 3)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    z_sq = z * z
    zero = torch.zeros_like(z)
    row0 = torch.stack([focal / z, zero, -(focal * x) / z_sq], dim=-1)
    row1 = torch.stack([zero, focal / z, -(focal * y) / z_sq], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def d_stereoproj_d_y(focal, baseline, xyz: torch.Tensor) -> torch.Tensor:
    """d(uvu)/d(camera-frame xyz): (..., 3, 3)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    z_sq = z * z
    zero = torch.zeros_like(z)
    row0 = torch.stack([focal / z, zero, -(focal * x) / z_sq], dim=-1)
    row1 = torch.stack([zero, focal / z, -(focal * y) / z_sq], dim=-1)
    row2 = torch.stack([focal / z, zero, -(focal * (x - baseline)) / z_sq],
                       dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def d_expy_d_y(y: torch.Tensor) -> torch.Tensor:
    """d(exp(xi) * y)/d(xi) at xi=0: (..., 3, 6) = [I | -hat(y)]."""
    eye = torch.eye(3, dtype=y.dtype, device=y.device).expand(
        *y.shape[:-1], 3, 3)
    return torch.cat([eye, -hat(y)], dim=-1)


def d_Tinvpsi_d_psi(T: SE3, psi: torch.Tensor) -> torch.Tensor:
    """d(T * invert_depth(psi))/d(psi): (..., 3, 3)."""
    x = invert_depth(psi)
    r1 = T.R[..., :, 0]
    r2 = T.R[..., :, 1]
    Rx = (T.R @ x[..., None])[..., 0]
    J = torch.stack([r1, r2, -Rx], dim=-1)
    return J / psi[..., 2:3, None]


# -- composite prediction models ---------------------------------------------

def predict_uvu_world(cam: StereoCamera, T_cw: SE3,
                      xyz_w: torch.Tensor) -> torch.Tensor:
    """World point -> uvu seen from T_cw."""
    return cam.map_uvu(T_cw.apply(xyz_w))


def frame_jac_uvu_world(cam: StereoCamera, T_cw: SE3,
                        xyz_w: torch.Tensor) -> torch.Tensor:
    """d(predict_uvu_world)/d(xi) for T <- exp(xi)*T: (..., 3, 6)."""
    y = T_cw.apply(xyz_w)
    return d_stereoproj_d_y(cam.focal, cam.baseline, y) @ d_expy_d_y(y)


def point_jac_uvu_world(cam: StereoCamera, T_cw: SE3,
                        xyz_w: torch.Tensor) -> torch.Tensor:
    """d(predict_uvu_world)/d(xyz_w): (..., 3, 3)."""
    y = T_cw.apply(xyz_w)
    return d_stereoproj_d_y(cam.focal, cam.baseline, y) @ T_cw.R


def predict_anchored_uvu(cam: StereoCamera, T_cw: SE3, A_aw: SE3,
                         psi_a: torch.Tensor) -> torch.Tensor:
    """Anchored inverse-depth point -> uvu seen from observer ``T_cw`` (the
    inner window's ternary factor)."""
    T_ca = T_cw @ A_aw.inverse()
    return cam.map_uvu(T_ca.apply(invert_depth(psi_a)))


def anchored_jacs(cam: StereoCamera, T_cw: SE3, A_aw: SE3,
                  psi_a: torch.Tensor):
    """(J_frame (...,3,6), J_anchor (...,3,6), J_point (...,3,3)) of
    :func:`predict_anchored_uvu`, wrt the left-multiplicative tangents of
    T_cw and A_aw and wrt psi_a."""
    T_ca = T_cw @ A_aw.inverse()
    x = invert_depth(psi_a)
    y = T_ca.apply(x)
    J_proj = d_stereoproj_d_y(cam.focal, cam.baseline, y)
    J_frame = J_proj @ d_expy_d_y(y)
    # y = T_cw * (exp(eps) * A_aw)^-1 * x = T_cw * A_aw^-1 * exp(-eps) * x
    J_anchor = -(J_proj @ T_ca.R @ d_expy_d_y(x))
    J_point = J_proj @ d_Tinvpsi_d_psi(T_ca, psi_a)
    return J_frame, J_anchor, J_point


def predict_uv_world(cam, T_cw: SE3, xyz_w: torch.Tensor) -> torch.Tensor:
    """World point -> mono uv."""
    return _pixels(cam, project2d(T_cw.apply(xyz_w)))


def frame_jac_uv_world(cam, T_cw: SE3, xyz_w: torch.Tensor) -> torch.Tensor:
    """d(predict_uv_world)/d(xi), T <- exp(xi) T: (..., 2, 6)."""
    y = T_cw.apply(xyz_w)
    return d_proj_d_y(cam.focal, y) @ d_expy_d_y(y)


def predict_uv_psi(cam, T_ca: SE3, psi: torch.Tensor) -> torch.Tensor:
    """Inverse-depth point in the reference camera -> mono uv in the
    observing camera."""
    return _pixels(cam, project2d(T_ca.apply(invert_depth(psi))))


def uv_psi_jacs(cam, T_ca: SE3, psi: torch.Tensor):
    """(J_frame (...,2,6), J_point (...,2,3)) of :func:`predict_uv_psi`."""
    y = T_ca.apply(invert_depth(psi))
    Jp = d_proj_d_y(cam.focal, y)
    return Jp @ d_expy_d_y(y), Jp @ d_Tinvpsi_d_psi(T_ca, psi)


def predict_uvu_psi(cam: StereoCamera, T_ca: SE3,
                    psi: torch.Tensor) -> torch.Tensor:
    """Non-anchored inverse-depth point -> stereo uvu."""
    return cam.map_uvu(T_ca.apply(invert_depth(psi)))


def uvu_psi_jacs(cam: StereoCamera, T_ca: SE3, psi: torch.Tensor):
    """(J_frame (...,3,6), J_point (...,3,3)) of :func:`predict_uvu_psi`."""
    y = T_ca.apply(invert_depth(psi))
    Jp = d_stereoproj_d_y(cam.focal, cam.baseline, y)
    return Jp @ d_expy_d_y(y), Jp @ d_Tinvpsi_d_psi(T_ca, psi)


def predict_uvu_from_uvu(cam: StereoCamera, T_c2_c1: SE3,
                         uvu_1: torch.Tensor) -> torch.Tensor:
    """A point parametrized by its first-view stereo observation -> its uvu
    in a second view (unmap, move, map)."""
    return cam.map_uvu(T_c2_c1.apply(cam.unmap_uvu(uvu_1)))


def predict_anchored_uv(cam, T_cw: SE3, A_aw: SE3,
                        psi_a: torch.Tensor) -> torch.Tensor:
    """Anchored inverse-depth point -> mono uv (the mono anchored
    measurement)."""
    T_ca = T_cw @ A_aw.inverse()
    return _pixels(cam, project2d(T_ca.apply(invert_depth(psi_a))))


def anchored_uv_jacs(cam, T_cw: SE3, A_aw: SE3, psi_a: torch.Tensor):
    """(J_frame, J_anchor, J_point) of :func:`predict_anchored_uv`."""
    T_ca = T_cw @ A_aw.inverse()
    x = invert_depth(psi_a)
    y = T_ca.apply(x)
    Jp = d_proj_d_y(cam.focal, y)
    J_frame = Jp @ d_expy_d_y(y)
    J_anchor = -(Jp @ T_ca.R @ d_expy_d_y(x))
    J_point = Jp @ d_Tinvpsi_d_psi(T_ca, psi_a)
    return J_frame, J_anchor, J_point


def relative_pose_error(T_21: SE3, T_1w: SE3, T_w2_inv: SE3) -> torch.Tensor:
    """log(T_21 * T_1w * T_2w^-1), the relative-pose edge error;
    ``T_w2_inv`` is the second vertex's stored pose T_2w."""
    return (T_21 @ T_1w @ T_w2_inv.inverse()).log()


def se3_right_jacobian_inv(d: torch.Tensor) -> torch.Tensor:
    """2nd-order BCH series J_r^{-1}(d) ~ I + 1/2 ad(d) + 1/12 ad(d)^2."""
    A = ad_se3(d)
    eye = torch.eye(6, dtype=d.dtype, device=d.device).expand(A.shape)
    return eye + 0.5 * A + (1.0 / 12.0) * (A @ A)


def se3_left_jacobian_inv(d: torch.Tensor) -> torch.Tensor:
    """J_l^{-1}(d) = J_r^{-1}(-d) ~ I - 1/2 ad(d) + 1/12 ad(d)^2."""
    return se3_right_jacobian_inv(-d)


def relative_pose_jacobians(T_21: SE3, T_1w: SE3, T_2w: SE3):
    """(d, J1, J2): the error of :func:`relative_pose_error` and its
    Jacobians wrt LEFT-multiplicative tangents of T_1w and T_2w (2nd-order
    BCH): J1 = Jl^-1(d) Adj(T_21), J2 = -Jr^-1(d)."""
    d = relative_pose_error(T_21, T_1w, T_2w)
    J1 = se3_left_jacobian_inv(d) @ T_21.adjoint()
    J2 = -se3_right_jacobian_inv(d)
    return d, J1, J2


# -- homography ---------------------------------------------------------------

def homography_c2_from_c1(T_c2_from_c1: SE3, normal_c1: torch.Tensor,
                          point_on_plane_c1: torch.Tensor) -> torch.Tensor:
    """Plane-induced homography H with x2 ~ H @ x1 (normalized coords):
    H = R + t n^T / d, d = n . p."""
    d = torch.sum(normal_c1 * point_on_plane_c1, dim=-1)
    return T_c2_from_c1.R + (T_c2_from_c1.t[..., :, None]
                             * normal_c1[..., None, :] / d[..., None, None])

"""Motion-only bundle adjustment: robust LM over one SE3 pose with the points
fixed (port of the stereo part of scavislam_tpu.models.pose_optimizer).

Pseudo-Huber IRLS weights, multiplicative damping from mu0 = 0.01, at most
MAX_ITERS accepted steps and MAX_TRIALS failed trials in a row,
left-multiplicative updates. Invalid observations are masked (weight 0) so
shapes stay fixed.

Like the dense tracker's, the LM control runs on the host on fetched
results (two small transfers per iteration). The uv (mono) optimizer and
``filter_points_info`` are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.core.lie import SE3, hat, se3_exp_host
from scavislam_tpu_torch.models.dense_tracker import (
    fetch_host,
    lm_damp,
    solve_spd_host,
    to_device_pose,
)

MAX_ITERS = 15
MAX_TRIALS = 5


class MotionOnlyResult(NamedTuple):
    T: SE3
    chi2: torch.Tensor
    num_obs: torch.Tensor
    residuals: torch.Tensor  # (N, 3) final obs - pred (level-0 uvu pixels)
    inlier_mask: torch.Tensor  # valid & finite prediction


def _predict(cam: StereoCamera, R, t, xyz_w):
    """uvu prediction for all points; also returns the camera-frame points
    and their depth."""
    y = xyz_w @ R.T + t
    x, yy = y[..., 0], y[..., 1]
    z = y[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    f = cam.focal
    u = x / z_safe * f + cam.pp[0]
    v = yy / z_safe * f + cam.pp[1]
    ur = (x - cam.baseline) / z_safe * f + cam.pp[0]
    return torch.stack([u, v, ur], dim=-1), y, z


def _jac(cam: StereoCamera, y):
    """d(uvu)/dxi (N, 3, 6) at camera-frame points y, left-multiplicative."""
    x, yy = y[..., 0], y[..., 1]
    z = y[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    f = cam.focal
    z2 = z_safe * z_safe
    zero = torch.zeros_like(z)
    r0 = torch.stack([f / z_safe, zero, -f * x / z2], dim=-1)
    r1 = torch.stack([zero, f / z_safe, -f * yy / z2], dim=-1)
    r2 = torch.stack([f / z_safe, zero, -f * (x - cam.baseline) / z2], dim=-1)
    Jproj = torch.stack([r0, r1, r2], dim=-2)  # (N, 3, 3)
    eye = torch.eye(3, dtype=y.dtype, device=y.device).expand(*y.shape[:-1], 3, 3)
    Jexp = torch.cat([eye, -hat(y)], dim=-1)  # (N, 3, 6)
    return Jproj @ Jexp


def _predict_and_jac(cam: StereoCamera, R, t, xyz_w):
    """uvu prediction + d(pred)/dxi for all points."""
    pred, y, z = _predict(cam, R, t, xyz_w)
    return pred, _jac(cam, y), z


def pseudo_huber_weight(chi2: torch.Tensor, delta: float):
    """IRLS weight for the pseudo-Huber kernel at squared error chi2."""
    return 1.0 / torch.sqrt(1.0 + chi2 / (delta * delta))


def motion_only_ba(cam: StereoCamera, T_init: SE3, xyz_w, obs_uvu, weights,
                   valid, huber_delta: float = 1.0) -> MotionOnlyResult:
    """Run the robust LM loop over the stereo (uvu) residuals."""

    def _masked_residuals(R, t):
        """Residuals with invalid / behind-camera / non-finite entries
        zeroed, and the camera-frame points the Jacobian needs."""
        pred, y, z = _predict(cam, R, t, xyz_w)
        r = obs_uvu - pred
        mask = valid & (z > 0.1) & torch.all(torch.isfinite(r), dim=-1)
        r = torch.where(mask[:, None], r, torch.zeros_like(r))
        return r, mask, y

    return _lm_pose_core(_masked_residuals, lambda y: _jac(cam, y), T_init,
                         weights, valid, huber_delta)


def _lm_pose_core(_masked_residuals, jacobian, T_init, weights, valid,
                  huber_delta):
    """The robust LM loop over one SE3 pose:
    `_masked_residuals(R, t) -> (r (N,D), mask (N,), aux)` and
    `jacobian(aux) -> J (N,D,6)`.

    The residual and normal-equation passes run on the points' device; the
    LM control (6x6 solve, SE3 update, damping, stop test) runs on the host
    in float32 numpy on the fetched results. The normal equations at an unchanged pose are
    reused after a rejected step (the twin recomputes the same values)."""
    dev = T_init.R.device

    def chi2_of(R, t):
        r, mask, _ = _masked_residuals(R, t)
        s = torch.sum(r * r, dim=-1)
        w = weights * pseudo_huber_weight(s, huber_delta) * mask
        return torch.sum(w * s)

    def normal_eq(R, t):
        r, mask, aux = _masked_residuals(R, t)
        s = torch.sum(r * r, dim=-1)
        w = weights * pseudo_huber_weight(s, huber_delta) * mask
        J = jacobian(aux)
        J = torch.where(mask[:, None, None], J, torch.zeros_like(J))
        Jw = J * w[:, None, None]
        H = torch.einsum("nij,nik->jk", Jw, J)
        b = torch.einsum("nij,ni->j", Jw, r)
        return H, b

    f32 = np.float32
    R, t = fetch_host(T_init.R, T_init.t)
    T_dev = T_init
    chi2_dev = chi2_of(T_dev.R, T_dev.t)
    (chi2,) = fetch_host(chi2_dev)
    mu, nu = f32(0.01), f32(2.0)
    trial = 0
    it = 0
    stop = False
    H = b = None
    while it < MAX_ITERS and not stop:
        if H is None:
            H, b = fetch_host(*normal_eq(T_dev.R, T_dev.t))
        x = solve_spd_host(lm_damp(H, mu), b)
        Re, te = se3_exp_host(x)
        R_new, t_new = (Re @ R).astype(f32), (Re @ t + te).astype(f32)
        T_new_dev = to_device_pose(R_new, t_new, dev)
        new_chi2_dev = chi2_of(T_new_dev.R, T_new_dev.t)
        (new_chi2,) = fetch_host(new_chi2_dev)
        rho = f32(chi2 - new_chi2)
        if rho > 0:
            # normalized gain ratio for the mu schedule
            denom = max(f32(np.sum(x * (mu * x + b))), f32(1e-20))
            rho_n = f32(rho / denom)
            mu = f32(mu * max(f32(1.0 / 3.0), f32(1.0) - (f32(2.0) * rho_n - f32(1.0)) ** 3))
            nu = f32(2.0)
            R, t, chi2, T_dev = R_new, t_new, new_chi2, T_new_dev
            chi2_dev = new_chi2_dev
            H = b = None
            trial = 0
            it += 1
            stop = bool(np.max(np.abs(x)) <= 1e-10)
        else:
            mu = f32(mu * nu)
            nu = f32(nu * 2.0)
            trial += 1
            stop = trial >= MAX_TRIALS

    residuals, inliers, _ = _masked_residuals(T_dev.R, T_dev.t)
    return MotionOnlyResult(
        T_dev, chi2_dev, torch.sum(valid.to(torch.int32)), residuals, inliers)

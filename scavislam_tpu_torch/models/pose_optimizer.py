"""Motion-only bundle adjustment: robust LM over one SE3 pose with the points
fixed (port of the stereo part of scavislam_tpu.models.pose_optimizer).

Pseudo-Huber IRLS weights, multiplicative damping from mu0 = 0.01, at most
MAX_ITERS accepted steps and MAX_TRIALS failed trials in a row,
left-multiplicative updates. Invalid observations are masked (weight 0) so
shapes stay fixed.

Two forms of the same loop. ``motion_only_ba`` (the frame step's) runs the
LM control on the host on fetched results, like the dense tracker: two small
transfers per iteration. ``motion_only_ba_robust`` (the backend's
registration) runs a fixed trip count of MAX_ITERS * MAX_TRIALS with masked
updates entirely on the device: the same answer, no host sync, so a
registration on the backend's stream never waits for the host. The uv (mono)
optimizer and ``filter_points_info`` are not ported yet.
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


def _stereo_residuals(cam: StereoCamera, xyz_w, obs_uvu, valid):
    """`_masked_residuals(R, t)` for the stereo (uvu) observations."""

    def _masked_residuals(R, t):
        pred, y, z = _predict(cam, R, t, xyz_w)
        r = obs_uvu - pred
        mask = valid & (z > 0.1) & torch.all(torch.isfinite(r), dim=-1)
        r = torch.where(mask[:, None], r, torch.zeros_like(r))
        return r, mask, y

    return _masked_residuals


def _lm_pose_fixed(_masked_residuals, jacobian, T_init: SE3, weights,
                   huber_delta):
    """The robust LM loop of `_lm_pose_core` as MAX_ITERS * MAX_TRIALS
    masked trips on the device (the bound on the twin's while_loop: at most
    MAX_TRIALS - 1 rejections before each of MAX_ITERS accepts). A trip
    past the loop's end changes nothing. Each trip evaluates chi2, H and b
    at the candidate pose in one pass; an accept carries them over, so H
    and b are always those of the current pose, as the twin recomputes
    them. Returns (R, t, chi2) tensors."""
    R, t = T_init.R, T_init.t
    dev, f32 = R.device, torch.float32

    def evaluate(R, t):
        r, mask, aux = _masked_residuals(R, t)
        s = torch.sum(r * r, dim=-1)
        w = weights * pseudo_huber_weight(s, huber_delta) * mask
        J = torch.where(mask[:, None, None], jacobian(aux), 0.0)
        Jw = J * w[:, None, None]
        return (torch.sum(w * s), torch.einsum("nij,nik->jk", Jw, J),
                torch.einsum("nij,ni->j", Jw, r))

    chi2, H, b = evaluate(R, t)
    # device fills: a host-built tensor would sync the stream
    mu = torch.full((), 0.01, dtype=f32, device=dev)
    nu = torch.full((), 2.0, dtype=f32, device=dev)
    trial = torch.zeros((), dtype=torch.int32, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    stop = torch.zeros((), dtype=torch.bool, device=dev)
    eye = torch.eye(6, dtype=f32, device=dev)
    for _ in range(MAX_ITERS * MAX_TRIALS):
        active = (it < MAX_ITERS) & ~stop
        Hd = H + mu * torch.diag(torch.diag(H)) + 1e-12 * eye
        L, info = torch.linalg.cholesky_ex(Hd)
        x = torch.cholesky_solve(b[:, None], L)[:, 0]
        x = torch.where(torch.isfinite(x) & (info == 0), x, 0.0)
        Te = SE3.exp(x)
        R_new, t_new = Te.R @ R, Te.R @ t + Te.t
        chi2_new, H_new, b_new = evaluate(R_new, t_new)
        gain = chi2 - chi2_new
        accept = active & (gain > 0)
        reject = active & ~(gain > 0)
        # normalized gain ratio for the mu schedule
        denom = torch.clamp(torch.sum(x * (mu * x + b)), min=1e-20)
        rho_n = gain / denom
        mu_acc = mu * torch.clamp(1.0 - (2.0 * rho_n - 1.0) ** 3, min=1.0 / 3.0)
        trial_new = torch.where(accept, 0, trial + 1)
        stop_new = torch.where(accept, torch.max(torch.abs(x)) <= 1e-10,
                               trial_new >= MAX_TRIALS)
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        chi2 = torch.where(accept, chi2_new, chi2)
        H = torch.where(accept, H_new, H)
        b = torch.where(accept, b_new, b)
        mu = torch.where(accept, mu_acc, torch.where(reject, mu * nu, mu))
        nu = torch.where(accept, 2.0, torch.where(reject, nu * 2.0, nu))
        trial = torch.where(active, trial_new, trial)
        it = torch.where(accept, it + 1, it)
        stop = torch.where(active, stop_new, stop)
    return R, t, chi2


def motion_only_ba_fixed(cam: StereoCamera, T_init: SE3, xyz_w, obs_uvu,
                         weights, valid, huber_delta: float = 1.0
                         ) -> MotionOnlyResult:
    """`motion_only_ba` as a fixed-trip device loop (`_lm_pose_fixed`)."""
    residuals_of = _stereo_residuals(cam, xyz_w, obs_uvu, valid)
    R, t, chi2 = _lm_pose_fixed(residuals_of, lambda y: _jac(cam, y), T_init,
                                weights, huber_delta)
    residuals, inliers, _ = residuals_of(R, t)
    return MotionOnlyResult(SE3(R, t), chi2, torch.sum(valid.to(torch.int32)),
                            residuals, inliers)


def motion_only_ba_robust(cam: StereoCamera, T_init: SE3, xyz_w, obs_uvu,
                          weights, valid, huber_delta: float = 1.0,
                          reject_thresh: float = 3.0, rounds: int = 2
                          ) -> MotionOnlyResult:
    """LM + outlier rejection: optimize, drop obs with max-component residual
    above ``reject_thresh`` pixels, re-optimize. Each round is the
    fixed-trip device loop, so the whole call runs without a host sync."""
    res = motion_only_ba_fixed(cam, T_init, xyz_w, obs_uvu, weights, valid,
                               huber_delta)
    keep = valid
    for _ in range(rounds - 1):
        keep = (keep & res.inlier_mask
                & (torch.amax(torch.abs(res.residuals), dim=-1) < reject_thresh))
        res = motion_only_ba_fixed(cam, res.T, xyz_w, obs_uvu, weights, keep,
                                   huber_delta)
    return res

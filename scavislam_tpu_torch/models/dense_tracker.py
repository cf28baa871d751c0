"""Dense photometric tracking, inverse-compositional LM (port of the parts of
scavislam_tpu.models.dense_tracker that the frame step runs).

Coarse-to-fine Levenberg-Marquardt on the clamped photometric residual
between the previous frame's back-projected cloud and the current image:
- residual r = I_ref - I_cur(pi(T x)), clamped to [-0.1, 0.1], 2-px border;
- the template Jacobian is computed once per cloud (``template_jacobian``);
- multiplicative damping H += mu * diag(H); accept if chi2 drops; mu *=
  max(1/3, 1-(2*rho-1)^3) on success, mu *= nu, nu *= 2 on failure; at most
  MAX_TRIALS failed trials in a row, MAX_ITERS accepted steps;
- update T <- T exp(-d) (inverse compositional).

Bilinear sampling has the exact semantics of the twin's ``_sample_qpack``
(clamped base, fractions from the clamped base); the tap-packing trick and
the bf16 matmul sampler are TPU workarounds and are not ported.

The per-point passes run on the device; the LM control runs on the host in
float32 numpy on the fetched 6x6 system (see ``_lm_level_ic``): one sync
per iteration, where the twin's ``lax.while_loop`` needs none. A fixed-trip
masked loop captured in a CUDA graph is the sync-free form; later work.
"""

from __future__ import annotations

import numpy as np
import torch

from scavislam_tpu_torch.core.lie import SE3, se3_exp_host
from scavislam_tpu_torch.ops.image import float_to_index

RES_CLAMP = 0.1
MAX_ITERS = 15
MAX_TRIALS = 2
BORDER = 2


def _proj_pose_jac(focal, xyz):
    """Rows of d(uv)/d(xi) for a LEFT-multiplicative increment at the given
    3-D points: (j0, j1) each (..., 6), tangent order [upsilon, omega]."""
    x, y = xyz[..., 0], xyz[..., 1]
    z = torch.where(torch.abs(xyz[..., 2]) < 1e-6,
                    torch.full_like(xyz[..., 2], 1e-6), xyz[..., 2])
    z2 = z * z
    f = focal
    zero = torch.zeros_like(z)
    j0 = torch.stack(
        [f / z, zero, -f * x / z2,
         -f * x * y / z2, f * (1.0 + x * x / z2), -f * y / z],
        dim=-1,
    )
    j1 = torch.stack(
        [zero, f / z, -f * y / z2,
         -f * (1.0 + y * y / z2), f * x * y / z2, f * x / z],
        dim=-1,
    )
    return j0, j1


def template_jacobian(focal, xyz_ref, dx_ref, dy_ref, valid):
    """Per-point inverse-compositional Jacobian (N, 6), computed once at the
    template frame from its exact integer-pixel gradients."""
    j0, j1 = _proj_pose_jac(focal, xyz_ref)
    J = dx_ref[..., None] * j0 + dy_ref[..., None] * j1
    return torch.where(valid[..., None], J, torch.zeros_like(J))


def _sample_exact(img, h, w, uv):
    """Bilinear sample with the twin's _sample_qpack semantics. Returns
    (values, in_bounds)."""
    u = uv[..., 0]
    v = uv[..., 1]
    valid = (u >= 0.0) & (v >= 0.0) & (u <= w - 1.0) & (v <= h - 1.0)
    u0c = float_to_index(torch.floor(u)).clamp(0, w - 2)
    v0c = float_to_index(torch.floor(v)).clamp(0, h - 2)
    fu = u - u0c.to(u.dtype)
    fv = v - v0c.to(v.dtype)
    flat = img.reshape(-1)
    base = (v0c * w + u0c).long()
    top = flat[base] * (1.0 - fu) + flat[base + 1] * fu
    bot = flat[base + w] * (1.0 - fu) + flat[base + w + 1] * fu
    return top * (1.0 - fv) + bot * fv, valid


def _ic_pass(cam, img, R, t, xyz_ref, i_ref, J_ref, valid):
    """One inverse-compositional evaluation at pose (R, t): masked
    (H, b, chi2) with the fixed template Jacobian."""
    h, w = img.shape
    xyz_cur = xyz_ref @ R.T + t
    z = xyz_cur[..., 2]
    uv = torch.stack([xyz_cur[..., 0] / z * cam.focal + cam.pp[0],
                      xyz_cur[..., 1] / z * cam.focal + cam.pp[1]], dim=-1)
    i_cur, _ = _sample_exact(img, h, w, uv)
    in_frame = (
        (uv[..., 0] >= BORDER)
        & (uv[..., 0] < w - BORDER)
        & (uv[..., 1] >= BORDER)
        & (uv[..., 1] < h - BORDER)
        & (z > 1e-6)
        & valid
    )
    res = torch.clamp(i_ref - i_cur, -RES_CLAMP, RES_CLAMP)
    res = torch.where(in_frame, res, torch.zeros_like(res))
    Jm = torch.where(in_frame[..., None], J_ref, torch.zeros_like(J_ref))
    H = Jm.T @ Jm
    b = Jm.T @ res
    chi2 = torch.sum(res * res)
    return H, b, chi2


def solve_spd_host(Hd: np.ndarray, rhs: np.ndarray) -> np.ndarray:
    """Cholesky solve of a 6x6 float32 system on the host; zeros where the
    factorization fails or the result is not finite (the twin's NaN -> 0
    guard)."""
    try:
        L = np.linalg.cholesky(Hd)
    except np.linalg.LinAlgError:
        return np.zeros_like(rhs)
    x = np.linalg.solve(L.T, np.linalg.solve(L, rhs)).astype(np.float32)
    return np.where(np.isfinite(x), x, np.float32(0.0))


def fetch_host(*tensors):
    """Copy small device results to the host in ONE transfer (one sync);
    returns float32 numpy arrays of the original shapes."""
    flat = torch.cat([x.reshape(-1).to(torch.float32)
                      for x in tensors]).cpu().numpy()
    out, o = [], 0
    for x in tensors:
        out.append(flat[o:o + x.numel()].reshape(tuple(x.shape)))
        o += x.numel()
    return out


def to_device_pose(R: np.ndarray, t: np.ndarray, device) -> SE3:
    """Upload a host pose in ONE transfer (asynchronous from pinned memory
    on a CUDA device)."""
    buf = torch.from_numpy(np.concatenate([R.reshape(-1), t]).astype(np.float32))
    if device.type == "cuda":
        buf = buf.pin_memory().to(device, non_blocking=True)
    return SE3(buf[:9].reshape(3, 3), buf[9:])


def lm_damp(H: np.ndarray, mu) -> np.ndarray:
    """H + mu * diag(H) + 1e-12 I (multiplicative LM damping), float32."""
    f32 = np.float32
    return (H + f32(mu) * np.diag(np.diag(H)) + f32(1e-12) * np.eye(6, dtype=f32)
            ).astype(f32)


def _lm_level_ic(cam, img, xyz_ref, i_ref, J_ref, valid, R0, t0,
                 max_iters=MAX_ITERS):
    """Inverse-compositional LM for one pyramid level. Returns (R, t, chi2,
    iters): R, t, chi2 on the image's device, iters the accepted steps.

    The per-point passes run on the image's device; the LM control (6x6
    solve, SE3 update, damping schedule, stop test) runs on the host in
    float32 numpy on the fetched (H, b, chi2) — one small transfer each way
    per iteration; the host reads `stop` there (the twin's lax.while_loop,
    evaluated eagerly)."""
    dev = img.device
    f32 = np.float32
    R, t = fetch_host(R0, t0)
    out = _ic_pass(cam, img, R0, t0, xyz_ref, i_ref, J_ref, valid)
    chi2_dev = out[2]
    H, b, chi2 = fetch_host(*out)
    mu, nu = f32(0.01), f32(2.0)
    trial = 0
    it = 0
    stop = False
    while it < max_iters and not stop:
        d = solve_spd_host(lm_damp(H, mu), -b)
        Re, te = se3_exp_host(-d)
        R_new, t_new = (R @ Re).astype(f32), (R @ te + t).astype(f32)
        Td = to_device_pose(R_new, t_new, dev)
        out = _ic_pass(cam, img, Td.R, Td.t, xyz_ref, i_ref, J_ref, valid)
        H_new, b_new, new_chi2 = fetch_host(*out)
        rho = f32(chi2 - new_chi2)
        if rho > 0:
            mu = f32(mu * max(f32(1.0 / 3.0), f32(1.0) - (f32(2.0) * rho - f32(1.0)) ** 3))
            nu = f32(2.0)
            R, t, H, b, chi2 = R_new, t_new, H_new, b_new, new_chi2
            chi2_dev = out[2]
            trial = 0
            it += 1
            stop = bool(np.max(np.abs(d)) <= 1e-5)
        else:
            mu = f32(mu * nu)
            nu = f32(nu * 2.0)
            trial += 1
            stop = trial >= MAX_TRIALS
    Td = to_device_pose(R, t, dev)
    return Td.R, Td.t, chi2_dev, it

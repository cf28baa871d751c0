"""The plain reference of a stereo frame step's pose: the mathematics of
what the step computes, written out in plain PyTorch, in float64 unless
told otherwise, with none of the program's implementation choices (no
fixed-trip loops, no batched retries, no packed samplers).

Its inputs:
- the two frames the benchmark rendered, the checked frame and the one
  before it (uint8 (2, H, W) stacks);
- the program's state that the step was handed: the previous frame's
  pose and the map (keyframe poses, anchored inverse-depth points, the
  candidate ids), which only a run of the whole system builds;
- the step's own matches (the level-0 observation of each candidate and
  whether it matched): outputs of the step, read here only to judge the
  pose they give, as a served model's tokens are read to judge them.

What it works out, in order:
1. both frames' disparity by plain block matching (``stereo_bm``);
2. the previous frame's dense cloud: every sampled pixel with a disparity
   back-projected, with its intensity and its inverse-compositional
   template Jacobian from the previous frame's pyramid and Sobel
   gradients;
3. dense photometric tracking of the checked frame against that cloud,
   coarse to fine from the identity: Levenberg-Marquardt on the clamped
   photometric residuals, plain bilinear sampling, the inverse-compositional
   update, and the twin's stopping rule (15 accepted steps, 2 rejections in
   a row, or an accepted step of at most 1e-5);
4. the robust motion-only bundle adjustment over the matches, started at
   the tracked pose: pseudo-Huber weights, level weights 4^-level, the
   twin's stopping rule (15 accepted steps; up to 5 retries at growing
   damping; an accepted step of at most 1e-10); a first round, the
   rejection of observations off by twice the reprojection limit, a second
   round;
5. the gate and the tracking floor: with fewer than 20 matched or gated
   observations the step keeps the tracked pose.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

BORDER = 2  # dense tracking's border in pixels, at every level
RES_CLAMP = 0.1  # photometric residuals are clamped to +-0.1
DENSE_ITERS, DENSE_TRIALS = 15, 2
BA_ITERS, BA_TRIALS = 15, 5
HUBER_DELTA = 1.0
MIN_OBS = 20  # the tracking floor
DAMPING_EPS = 1e-12


class Camera(NamedTuple):
    f: float
    ppx: float
    ppy: float
    baseline: float

    def level(self, l: int) -> "Camera":
        """Pyramid level l: focal halves, pixel centres stay centres, the
        baseline doubles (so f * b, and a depth's disparity, hold)."""
        s = 2 ** l
        return Camera(self.f / s, (self.ppx + 0.5) / s - 0.5,
                      (self.ppy + 0.5) / s - 0.5, self.baseline * s)


# -- images -------------------------------------------------------------------

def _correlate(img, taps, dim):
    """sum_i taps[i] * img[j + i - r] along `dim`, wrapping at the border
    (the twin's rolled filters)."""
    r = len(taps) // 2
    out = torch.zeros_like(img)
    for i, w in enumerate(taps):
        if w:
            out = out + w * torch.roll(img, r - i, dims=dim)
    return out


def pyramid(img, levels: int) -> list:
    """5-tap binomial blur, then every second row and column."""
    k = [1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16]
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(_correlate(_correlate(pyr[-1], k, 0), k, 1)[::2, ::2])
    return pyr


def gradients(img):
    """Sobel x and y over 8: centred differences of the smoothed image."""
    gx = _correlate(_correlate(img, [1, 2, 1], 0), [-1, 0, 1], 1) / 8
    gy = _correlate(_correlate(img, [1, 2, 1], 1), [-1, 0, 1], 0) / 8
    return gx, gy


def bilinear(img, u, v):
    """Bilinear interpolation at (u, v), which lie inside the image."""
    w = img.shape[1]
    u0 = torch.floor(u).long()
    v0 = torch.floor(v).long()
    a = u - u0
    b = v - v0
    flat = img.reshape(-1)
    i = v0 * w + u0
    top = flat[i] * (1 - a) + flat[i + 1] * a
    bot = flat[i + w] * (1 - a) + flat[i + w + 1] * a
    return top * (1 - b) + bot * b


# -- rigid motions --------------------------------------------------------------

def hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def exp_se3(xi):
    """(R, t) of the tangent [translation, rotation]."""
    ups, om = xi[:3], xi[3:]
    th2 = torch.sum(om * om)
    th = torch.sqrt(th2)
    small = th2 < 1e-8
    th_s = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1 - th2 / 6, torch.sin(th_s) / th_s)
    b = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(th_s)) / th_s ** 2)
    c = torch.where(small, 1 / 6 - th2 / 120,
                    (th_s - torch.sin(th_s)) / th_s ** 3)
    W = hat(om)
    W2 = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    return eye + a * W + b * W2, (eye + b * W + c * W2) @ ups


def _solve_damped(H, rhs, mu):
    """(H + mu diag(H) + eps I)^-1 rhs by Cholesky; zero where that fails."""
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    L, info = torch.linalg.cholesky_ex(H + mu * torch.diag(torch.diag(H))
                                       + DAMPING_EPS * eye)
    if int(info) != 0:
        return torch.zeros_like(rhs)
    x = torch.cholesky_solve(rhs[:, None], L)[:, 0]
    return x if bool(torch.isfinite(x).all()) else torch.zeros_like(rhs)


def _uv_jacobian(f, p):
    """d(u, v)/d(tangent) of a point p moved by a left increment: (N, 6)
    rows for u and for v."""
    x, y = p[:, 0], p[:, 1]
    z = torch.where(p[:, 2].abs() < 1e-6, torch.full_like(p[:, 2], 1e-6),
                    p[:, 2])
    o = torch.zeros_like(z)
    ju = torch.stack([f / z, o, -f * x / z ** 2, -f * x * y / z ** 2,
                      f * (1 + x * x / z ** 2), -f * y / z], -1)
    jv = torch.stack([o, f / z, -f * y / z ** 2, -f * (1 + y * y / z ** 2),
                      f * x * y / z ** 2, f * x / z], -1)
    return ju, jv


# -- dense tracking -------------------------------------------------------------

class Cloud(NamedTuple):
    xyz: torch.Tensor  # (N, 3) in the previous frame
    intensity: torch.Tensor  # (N,)
    J: torch.Tensor  # (N, 6) template Jacobian
    valid: torch.Tensor  # (N,)


def dense_cloud(img, disp, cam: Camera, subsample, dtype) -> list:
    """The previous frame's cloud per level: level l takes every
    (2^l * subsample[l])-th pixel of the level-0 disparity, back-projected
    with the level camera, and every subsample[l]-th pixel of the level's
    image and gradients."""
    pyr = pyramid(img, len(subsample))
    out = []
    for l, sub in enumerate(subsample):
        c = cam.level(l)
        s = 2 ** l
        d = disp[::s * sub, ::s * sub].to(dtype)
        hh, ww = d.shape
        valid = d > 0
        z = c.f * c.baseline / torch.where(valid, d, torch.ones_like(d))
        u = torch.arange(ww, dtype=dtype, device=d.device)[None, :] * sub
        v = torch.arange(hh, dtype=dtype, device=d.device)[:, None] * sub
        xyz = torch.stack([((u - c.ppx) / c.f * z).reshape(-1),
                           ((v - c.ppy) / c.f * z).reshape(-1),
                           z.reshape(-1)], -1)
        gx, gy = gradients(pyr[l])
        ju, jv = _uv_jacobian(c.f, xyz)
        J = gx[::sub, ::sub].reshape(-1, 1) * ju + gy[::sub, ::sub].reshape(
            -1, 1) * jv
        valid = valid.reshape(-1)
        out.append(Cloud(xyz, pyr[l][::sub, ::sub].reshape(-1),
                         torch.where(valid[:, None], J, torch.zeros_like(J)),
                         valid))
    return out


def _photometric(c: Camera, img, cloud: Cloud, R, t):
    """(H, b, chi2) of the clamped residuals at pose (R, t), with the fixed
    template Jacobian over the points that land inside the border."""
    p = cloud.xyz @ R.T + t
    z = p[:, 2]
    u = p[:, 0] / z * c.f + c.ppx
    v = p[:, 1] / z * c.f + c.ppy
    h, w = img.shape
    inside = ((u >= BORDER) & (u < w - BORDER) & (v >= BORDER)
              & (v < h - BORDER) & (z > 1e-6) & cloud.valid)
    i_cur = bilinear(img, torch.where(inside, u, torch.full_like(u, BORDER)),
                     torch.where(inside, v, torch.full_like(v, BORDER)))
    r = torch.clamp(cloud.intensity - i_cur, -RES_CLAMP, RES_CLAMP)
    r = torch.where(inside, r, torch.zeros_like(r))
    J = torch.where(inside[:, None], cloud.J, torch.zeros_like(cloud.J))
    return J.T @ J, J.T @ r, torch.sum(r * r)


def _dense_level(c: Camera, img, cloud: Cloud, R, t):
    H, b, chi2 = _photometric(c, img, cloud, R, t)
    mu, nu, rejections, accepted = 0.01, 2.0, 0, 0
    while accepted < DENSE_ITERS:
        d = _solve_damped(H, -b, mu)
        Re, te = exp_se3(-d)
        Rn, tn = R @ Re, R @ te + t  # inverse-compositional: T exp(-d)
        Hn, bn, chi2n = _photometric(c, img, cloud, Rn, tn)
        gain = float(chi2 - chi2n)
        if gain > 0:
            R, t, H, b, chi2 = Rn, tn, Hn, bn, chi2n
            mu *= max(1 / 3, 1 - (2 * gain - 1) ** 3)
            nu, rejections = 2.0, 0
            accepted += 1
            if float(d.abs().max()) <= 1e-5:
                break
        else:
            mu *= nu
            nu *= 2
            rejections += 1
            if rejections >= DENSE_TRIALS:
                break
    return R, t


def dense_track(img, clouds, cam: Camera, dtype):
    """The motion from the previous frame to this one, coarse to fine."""
    pyr = pyramid(img, len(clouds))
    R = torch.eye(3, dtype=dtype, device=img.device)
    t = torch.zeros(3, dtype=dtype, device=img.device)
    for l in reversed(range(len(clouds))):
        R, t = _dense_level(cam.level(l), pyr[l], clouds[l], R, t)
    return R, t


# -- motion-only bundle adjustment ---------------------------------------------

def _reprojection(c: Camera, xyz_w, obs, weights, valid, R, t, jac: bool):
    """The robust cost's chi2 at (R, t), the masked residuals and the mask;
    with `jac`, its Gauss-Newton H and b as well."""
    y = xyz_w @ R.T + t
    z = y[:, 2]
    zs = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    pred = torch.stack([y[:, 0] / zs * c.f + c.ppx,
                        y[:, 1] / zs * c.f + c.ppy,
                        (y[:, 0] - c.baseline) / zs * c.f + c.ppx], -1)
    r = obs - pred
    mask = valid & (z > 0.1) & torch.isfinite(r).all(-1)
    r = torch.where(mask[:, None], r, torch.zeros_like(r))
    s = torch.sum(r * r, -1)
    w = weights * mask / torch.sqrt(1 + s / HUBER_DELTA ** 2)
    chi2 = torch.sum(w * s)
    if not jac:
        return chi2, r, mask
    o = torch.zeros_like(zs)
    f = c.f
    Jp = torch.stack([
        torch.stack([f / zs, o, -f * y[:, 0] / zs ** 2], -1),
        torch.stack([o, f / zs, -f * y[:, 1] / zs ** 2], -1),
        torch.stack([f / zs, o, -f * (y[:, 0] - c.baseline) / zs ** 2], -1),
    ], -2)
    eye = torch.eye(3, dtype=y.dtype, device=y.device).expand(len(y), 3, 3)
    J = Jp @ torch.cat([eye, -hat(y)], -1)  # (N, 3, 6)
    J = torch.where(mask[:, None, None], J, torch.zeros_like(J))
    Jw = (J * w[:, None, None]).reshape(-1, 6)
    return chi2, r, mask, Jw.T @ J.reshape(-1, 6), Jw.T @ r.reshape(-1)


def motion_only_ba(c: Camera, xyz_w, obs, weights, valid, R, t):
    """Levenberg-Marquardt over one pose, the points fixed: (R, t, masked
    residuals at the end, mask)."""
    chi2, _, _, H, b = _reprojection(c, xyz_w, obs, weights, valid, R, t,
                                     True)
    mu = 0.01
    for _ in range(BA_ITERS):
        m, nu = mu, 2.0
        for _ in range(BA_TRIALS):
            x = _solve_damped(H, b, m)
            Re, te = exp_se3(x)
            Rn, tn = Re @ R, Re @ t + te  # left increment: exp(x) T
            gain = float(chi2 - _reprojection(c, xyz_w, obs, weights, valid,
                                              Rn, tn, False)[0])
            if gain > 0:
                break
            m *= nu
            nu *= 2
        else:
            break  # no retry lowered the cost
        denom = max(float(torch.sum(x * (m * x + b))), 1e-20)
        mu = m * max(1 / 3, 1 - (2 * gain / denom - 1) ** 3)
        R, t = Rn, tn
        chi2, _, _, H, b = _reprojection(c, xyz_w, obs, weights, valid, R, t,
                                         True)
        if float(x.abs().max()) <= 1e-10:
            break
    _, r, mask = _reprojection(c, xyz_w, obs, weights, valid, R, t, False)
    return R, t, r, mask


def map_points(poses, points, cand, dtype):
    """World points and pyramid levels of the candidates: a point's
    (x/z, y/z, 1/z) in its anchor keyframe, moved to the world."""
    pose_R, pose_t = poses[0].to(dtype), poses[1].to(dtype)
    psi, anchor, level = points[0].to(dtype), points[1], points[2]
    safe = cand.clamp(0, len(psi) - 1).long()
    q = psi[safe, 2:3]
    q = torch.where(q.abs() < 1e-9, torch.full_like(q, 1e-9), q)
    xyz_a = torch.cat([psi[safe, :2], torch.ones_like(q)], -1) / q
    a = anchor[safe].clamp(0, len(pose_R) - 1).long()
    # R_aw^T (x_a - t_aw), as row vectors
    xyz_w = ((xyz_a - pose_t[a])[:, None, :] @ pose_R[a])[:, 0]
    return xyz_w, level[safe]


# -- the frame step's pose --------------------------------------------------------

class StepInputs(NamedTuple):
    prev_frames: torch.Tensor  # uint8 (2, H, W)
    frames: torch.Tensor  # uint8 (2, H, W)
    prev_disp: torch.Tensor  # plain block matching of prev_frames
    R_prev: torch.Tensor  # the previous frame's pose, world -> camera
    t_prev: torch.Tensor
    poses: tuple  # keyframe (R (K, 3, 3), t (K, 3))
    points: tuple  # (psi (P, 3), anchor (P,), level (P,))
    cand: torch.Tensor  # (C,) candidate point ids, -1 padded
    obs: torch.Tensor  # (C, 3) the step's observations
    matched: torch.Tensor  # (C,) which of them matched


def frame_pose(x: StepInputs, cam: Camera, subsample, max_reproj: float,
               dtype=torch.float64):
    """The pose (R_cw, t_cw) the frame step should return."""
    prev = x.prev_frames[0].to(dtype) / 255
    cur = x.frames[0].to(dtype) / 255
    clouds = dense_cloud(prev, x.prev_disp, cam, subsample, dtype)
    R_d, t_d = dense_track(cur, clouds, cam, dtype)
    R_prev, t_prev = x.R_prev.to(dtype), x.t_prev.to(dtype)
    R, t = R_d @ R_prev, R_d @ t_prev + t_d

    xyz_w, level = map_points(x.poses, x.points, x.cand, dtype)
    matched = x.matched.bool()
    obs = x.obs.to(dtype)
    weights = 0.25 ** level.to(dtype) * matched
    R1, t1, r1, m1 = motion_only_ba(cam, xyz_w, obs, weights, matched, R, t)
    keep = matched & m1 & (r1.abs().amax(-1) < 2 * max_reproj)
    R2, t2, r2, m2 = motion_only_ba(cam, xyz_w, obs, weights, keep, R1, t1)
    lim = max_reproj * 2.0 ** level.to(dtype)
    gate = (matched & m2 & (r2[:, 0].abs() < lim) & (r2[:, 1].abs() < lim)
            & ((r2[:, 0] - r2[:, 2]).abs() < 6))
    if int(matched.sum()) >= MIN_OBS and int(gate.sum()) >= MIN_OBS:
        return R2, t2
    return R, t

"""The plain reference of a monocular frame step: the mathematics of what
the step computes from its matches, written out in plain PyTorch, in
float64 unless told otherwise, with none of the program's implementation
choices (no fixed-trip loops, no batched retries, no masked scatters).

Its inputs:
- the program's state that the step was handed: the previous frame's
  pose (the monocular step has no dense tracker: it starts where the last
  frame ended), the keyframe poses, the anchored inverse-depth points with
  their levels, each point's 3x3 information matrix, the candidate ids,
  and the two settings that weigh candidates (the information above which
  a point's depth counts as converged, and the weight of the others);
- the step's own matches (the level-0 uv observation of each candidate
  and whether it matched): outputs of the step, read here only to judge
  the pose and the depths they give.

What it works out, in order:
1. the candidates' world points, from their anchor keyframes;
2. the robust motion-only bundle adjustment over the uv residuals, from
   the previous pose: pseudo-Huber weights, level weights 4^-level, the
   unconverged candidates at the small weight; the stopping rule of the
   stereo reference (15 accepted steps; up to 5 retries at growing
   damping; an accepted step of at most 1e-10); a first round, the
   rejection of observations off by twice the reprojection limit, a
   second round;
3. the gate (both uv residuals within the reprojection limit times
   2^level) and the tracking floor: with fewer than 15 matched or gated
   observations the step keeps the previous pose;
4. the information-filter update of every gated candidate's inverse
   depth (Strasdat et al., RSS 2010, the reference's
   filterSingleFeatureOnly): 5 Levenberg-Marquardt steps on the
   reprojection error plus the Mahalanobis prior of the handed point,
   seen from the pose of step 3.

The matches themselves are judged against the scene (``match_errors``):
each matched candidate's ray, cast from its anchor keyframe's true pose
through the pixel it was made at, meets the scene's planes at the point
whose true projection into the frame the match should find.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from perfbench.reference.frame import (
    BA_ITERS,
    BA_TRIALS,
    HUBER_DELTA,
    _solve_damped,
    exp_se3,
    hat,
    map_points,
)

MIN_OBS = 15  # the monocular tracking floor
FILTER_ITERS = 5


class Camera(NamedTuple):
    f: float
    ppx: float
    ppy: float


class MonoInputs(NamedTuple):
    R_prev: torch.Tensor  # the previous frame's pose, world -> camera
    t_prev: torch.Tensor
    poses: tuple  # keyframe (R (K, 3, 3), t (K, 3))
    points: tuple  # (psi (P, 3), anchor (P,), level (P,))
    info: torch.Tensor  # (P, 3, 3) each point's information matrix
    cand: torch.Tensor  # (C,) candidate point ids, -1 padded
    conv_info: float  # depth information above which a point converged
    prior_weight: float  # the weight of the other candidates
    obs: torch.Tensor  # (C, 2) the step's uv observations
    matched: torch.Tensor  # (C,) which of them matched


class MonoStep(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    gate: torch.Tensor  # (C,)
    psi: torch.Tensor  # (C, 3) each candidate's point after the filter


def _project(c: Camera, y):
    z = y[:, 2]
    zs = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    return torch.stack([y[:, 0] / zs * c.f + c.ppx,
                        y[:, 1] / zs * c.f + c.ppy], -1), z, zs


def _reprojection(c: Camera, xyz_w, obs, weights, valid, R, t, jac: bool):
    """The robust cost's chi2 at (R, t), the masked uv residuals and the
    mask; with `jac`, its Gauss-Newton H and b as well."""
    y = xyz_w @ R.T + t
    pred, z, zs = _project(c, y)
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
    ], -2)
    eye = torch.eye(3, dtype=y.dtype, device=y.device).expand(len(y), 3, 3)
    J = Jp @ torch.cat([eye, -hat(y)], -1)  # (N, 2, 6)
    J = torch.where(mask[:, None, None], J, torch.zeros_like(J))
    Jw = (J * w[:, None, None]).reshape(-1, 6)
    return chi2, r, mask, Jw.T @ J.reshape(-1, 6), Jw.T @ r.reshape(-1)


def motion_only_ba(c: Camera, xyz_w, obs, weights, valid, R, t):
    """Levenberg-Marquardt over one pose, the points fixed, on the uv
    residuals: (R, t, masked residuals at the end, mask). The schedule of
    ``frame.motion_only_ba``."""
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


def filter_depths(c: Camera, R_ca, t_ca, psi0, info, obs, valid):
    """Each valid point's (x/z, y/z, 1/z) in its anchor, refined against
    one uv observation from a camera at (R_ca, t_ca) relative to the
    anchor, under the prior (psi0, info): Levenberg-Marquardt on
    |obs - proj(psi)|^2 + (psi0 - psi)^T info (psi0 - psi), damping
    0.01 (a third at an accepted step, doubling growth at a rejected
    one). Returns the refined points (the others as handed)."""
    eye = torch.eye(3, dtype=psi0.dtype, device=psi0.device)

    def residual(p):
        q = p[:, 2:3]
        q = torch.where(q.abs() < 1e-9, torch.full_like(q, 1e-9), q)
        xyz_a = torch.cat([p[:, :2], torch.ones_like(q)], -1) / q
        y = (R_ca @ xyz_a[:, :, None])[:, :, 0] + t_ca
        uv, _, zs = _project(c, y)
        return obs - uv, y, zs, q

    def cost(p):
        d = psi0 - p
        r = residual(p)[0]
        return (torch.sum(r * r, -1)
                + (d[:, None, :] @ info @ d[:, :, None])[:, 0, 0])

    def jacobian(p):
        """d proj / d psi, (N, 2, 3)."""
        r, y, zs, q = residual(p)
        o = torch.zeros_like(zs)
        Jp = torch.stack([
            torch.stack([c.f / zs, o, -c.f * y[:, 0] / zs ** 2], -1),
            torch.stack([o, c.f / zs, -c.f * y[:, 1] / zs ** 2], -1),
        ], -2)
        bearing = torch.cat([p[:, :2], torch.ones_like(q)], -1)
        # y = R_ca bearing / q + t_ca
        dy = torch.stack([R_ca[:, :, 0], R_ca[:, :, 1],
                          -(R_ca @ bearing[:, :, None])[:, :, 0] / q],
                         -1) / q[:, :, None]
        return r, Jp @ dy

    p, f = psi0, cost(psi0)
    mu = torch.full_like(f, 0.01)
    nu = torch.full_like(f, 2.0)
    for _ in range(FILTER_ITERS):
        r, J = jacobian(p)
        H = info + J.transpose(1, 2) @ J + mu[:, None, None] * eye
        g = ((J.transpose(1, 2) @ r[:, :, None])[:, :, 0]
             + (info @ (psi0 - p)[:, :, None])[:, :, 0])
        p_new = p + torch.linalg.solve(H, g)
        f_new = cost(p_new)
        ok = valid & (f_new < f) & torch.isfinite(p_new).all(-1)
        p = torch.where(ok[:, None], p_new, p)
        f = torch.where(ok, f_new, f)
        mu = torch.where(ok, mu / 3, mu * nu)
        nu = torch.where(ok, torch.full_like(nu, 2.0), nu * 2)
    return torch.where(valid[:, None], p, psi0)


def mono_step(x: MonoInputs, cam: Camera, max_reproj: float,
              dtype=torch.float64) -> MonoStep:
    """The pose, the gate and the filtered points the step should give."""
    R_prev, t_prev = x.R_prev.to(dtype), x.t_prev.to(dtype)
    xyz_w, level = map_points(x.poses, x.points, x.cand, dtype)
    safe = x.cand.clamp(0, len(x.points[0]) - 1).long()
    info = x.info[safe].to(dtype)
    matched = x.matched.bool()
    obs = x.obs.to(dtype)
    conf = torch.where(info[:, 2, 2] > x.conv_info,
                       torch.ones_like(info[:, 2, 2]),
                       torch.full_like(info[:, 2, 2], x.prior_weight))
    weights = 0.25 ** level.to(dtype) * conf * matched
    R1, t1, r1, m1 = motion_only_ba(cam, xyz_w, obs, weights, matched,
                                    R_prev, t_prev)
    keep = matched & m1 & (r1.abs().amax(-1) < 2 * max_reproj)
    R2, t2, r2, m2 = motion_only_ba(cam, xyz_w, obs, weights, keep, R1, t1)
    lim = max_reproj * 2.0 ** level.to(dtype)
    gate = matched & m2 & (r2[:, 0].abs() < lim) & (r2[:, 1].abs() < lim)
    if int(matched.sum()) >= MIN_OBS and int(gate.sum()) >= MIN_OBS:
        R, t = R2, t2
    else:
        R, t = R_prev, t_prev
    # each candidate seen from its anchor: R_ca = R_cw R_aw^T
    pose_R, pose_t = x.poses[0].to(dtype), x.poses[1].to(dtype)
    a = x.points[1][safe].clamp(0, len(pose_R) - 1).long()
    R_ca = R @ pose_R[a].transpose(1, 2)
    t_ca = t - (R_ca @ pose_t[a][:, :, None])[:, :, 0]
    psi = filter_depths(cam, R_ca, t_ca, x.points[0][safe].to(dtype), info,
                        obs, gate)
    return MonoStep(R, t, gate, psi)


def scene_point(planes, R_cw, t_cw, uv, cam: Camera):
    """Where the rays through pixels `uv` (N, 2) of a camera at the true
    pose (R_cw, t_cw) first meet the scene's planes, as the renderer
    casts them (a hit nearer than 0.1 along the ray is none): (N, 3)
    world points, inf where no plane is hit."""
    dt = uv.dtype
    d_c = torch.stack([(uv[:, 0] - cam.ppx) / cam.f,
                       (uv[:, 1] - cam.ppy) / cam.f,
                       torch.ones_like(uv[:, 0])], -1)
    d_w = d_c @ R_cw  # R_cw^T d
    o_w = -(R_cw.T @ t_cw)
    best = torch.full_like(uv[:, 0], float("inf"))
    for p in planes:
        if not hasattr(p, "offset"):
            raise ValueError(f"only planes are cast here, not {p!r}")
        n = torch.tensor(p.normal, dtype=dt)
        den = d_w @ n
        den = torch.where(den.abs() < 1e-9, torch.full_like(den, 1e-9), den)
        t = (p.offset - o_w @ n) / den
        best = torch.minimum(best, torch.where(
            t > 0.1, t, torch.full_like(t, float("inf"))))
    return o_w + best[:, None] * d_w


def match_errors(planes, truth: dict, anchor, level, uv0, cand, obs,
                 matched, cam: Camera):
    """Each matched candidate's distance (level pixels) from its true
    position: the point its anchor keyframe saw at its creation pixel
    `uv0` (level 0), projected by the frame's true pose. `truth` holds
    the frame's true pose (``frame``: (R_cw, t_cw)) and each keyframe's
    (``keyframes``: {keyframe id: (R_cw, t_cw)}), world to camera. On the
    host, wherever the step's tensors are."""
    anchor, level, uv0, cand, obs, matched = (
        x.cpu() for x in (anchor, level, uv0, cand, obs, matched))
    sel = matched.bool() & (cand >= 0)
    ids = cand[sel].long()
    if not len(ids):
        return torch.zeros(0, dtype=torch.float64)
    a = anchor[ids].long()
    uv_a = uv0[ids].double()
    xyz = torch.empty((len(ids), 3), dtype=torch.float64)
    for k in a.unique().tolist():
        R, t = (x.cpu().double() for x in truth["keyframes"][k])
        m = a == k
        xyz[m] = scene_point(planes, R, t, uv_a[m], cam)
    R, t = (x.cpu().double() for x in truth["frame"])
    uv, _, _ = _project(cam, xyz @ R.T + t)
    err = (obs[sel].double() - uv).norm(dim=-1)
    return err / 2.0 ** level[ids].double()


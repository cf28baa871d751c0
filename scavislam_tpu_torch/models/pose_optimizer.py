"""Motion-only bundle adjustment: robust LM over one SE3 pose with the points
fixed, and the monocular point filter (port of
scavislam_tpu.models.pose_optimizer).

Pseudo-Huber IRLS weights, multiplicative damping from mu0 = 0.01, at most
MAX_ITERS accepted steps and MAX_TRIALS failed trials in a row,
left-multiplicative updates. Invalid observations are masked (weight 0) so
shapes stay fixed.

One form of the loop, ``_lm_pose_fixed``: a fixed trip count with masked
updates entirely on the device, MAX_ITERS trips, each solving and scoring
an iteration's MAX_TRIALS damped retries at once; the twin's answer with no
host sync. ``motion_only_ba`` (the stereo frame step's, called twice per
frame), ``motion_only_ba_robust`` (the backend's registration) and
``motion_only_ba_uv`` (the mono step's, over 2-component uv residuals) all
run it, so the frame steps capture into CUDA graphs and a registration on
the backend's stream never waits for the host.

``filter_points_info`` is the batched single-landmark information filter
of the mono step: 5 fixed LM iterations per landmark, all landmarks at
once, masked.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.core.lie import SE3, hat
from scavislam_tpu_torch.models.ba_solver import _inv3x3
from scavislam_tpu_torch.models.dense_tracker import lm_exits_early

MAX_ITERS = 15
MAX_TRIALS = 5


class MotionOnlyResult(NamedTuple):
    T: SE3
    chi2: torch.Tensor
    num_obs: torch.Tensor
    residuals: torch.Tensor  # (N, 3) final obs - pred (level-0 uvu pixels)
    inlier_mask: torch.Tensor  # valid & finite prediction


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


def _transform(R, t, xyz_w):
    """Camera-frame points of `xyz_w` (N, 3) under R (..., 3, 3), t (..., 3):
    (..., N, 3), batched over the poses."""
    return torch.einsum("...ij,nj->...ni", R, xyz_w) + t[..., None, :]


def _predict_uv(focal, ppx, ppy, R, t, xyz_w):
    """Monocular uv prediction for all points, with the camera-frame points
    and their depth (batched over leading pose dims)."""
    y = _transform(R, t, xyz_w)
    z = y[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    u = y[..., 0] / z_safe * focal + ppx
    v = y[..., 1] / z_safe * focal + ppy
    return torch.stack([u, v], dim=-1), y, z


def _jac_uv(focal, y):
    """d(uv)/dxi (N, 2, 6) at camera-frame points y, left-multiplicative
    (the MONO prediction model, transformations.h:116-139,623-660)."""
    z = y[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    z2 = z_safe * z_safe
    zero = torch.zeros_like(z)
    r0 = torch.stack([focal / z_safe, zero, -focal * y[..., 0] / z2], dim=-1)
    r1 = torch.stack([zero, focal / z_safe, -focal * y[..., 1] / z2], dim=-1)
    Jproj = torch.stack([r0, r1], dim=-2)  # (N, 2, 3)
    eye = torch.eye(3, dtype=y.dtype, device=y.device).expand(*y.shape[:-1], 3, 3)
    return Jproj @ torch.cat([eye, -hat(y)], dim=-1)


def _predict_and_jac_uv(focal, ppx, ppy, R, t, xyz_w):
    """uv prediction + d(pred)/dxi for all points."""
    pred, y, z = _predict_uv(focal, ppx, ppy, R, t, xyz_w)
    return pred, _jac_uv(focal, y), z


def pseudo_huber_weight(chi2: torch.Tensor, delta: float):
    """IRLS weight for the pseudo-Huber kernel at squared error chi2."""
    return 1.0 / torch.sqrt(1.0 + chi2 / (delta * delta))


def _stereo_residuals(cam: StereoCamera, xyz_w, obs_uvu, valid):
    """`_masked_residuals(R, t)` for the stereo (uvu) observations, batched
    over leading pose dims."""
    f, (ppx, ppy), bl = cam.focal, cam.pp, cam.baseline

    def _masked_residuals(R, t):
        y = _transform(R, t, xyz_w)
        z = y[..., 2]
        z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
        pred = torch.stack([y[..., 0] / z_safe * f + ppx,
                            y[..., 1] / z_safe * f + ppy,
                            (y[..., 0] - bl) / z_safe * f + ppx], dim=-1)
        r = obs_uvu - pred
        mask = valid & (z > 0.1) & torch.all(torch.isfinite(r), dim=-1)
        r = torch.where(mask[..., None], r, torch.zeros_like(r))
        return r, mask, y

    return _masked_residuals


def _lm_pose_fixed(_masked_residuals, jacobian, T_init: SE3, weights,
                   huber_delta):
    """The twin's robust LM loop over one SE3 pose as a fixed trip count on
    the device, no host read: `_masked_residuals(R, t) -> (r (..., N, D),
    mask (..., N), aux)` and `jacobian(aux) -> J (N, D, 6)`. Between two
    accepted steps the pose, H and b do not change and each retry's damping
    follows from the last accept (mu, 2 mu, 8 mu, ...), so one trip solves
    and scores all MAX_TRIALS retries of an iteration at once and takes the
    first that lowers chi2, as the twin's while_loop takes them one after
    the other; none lowering it is the twin's stop after MAX_TRIALS
    rejections. MAX_ITERS trips bound the
    twin's accepts; a trip past its end changes nothing. The chosen step is
    applied and evaluated again as a single pose (chi2, H and b of the new
    pose), so that the accepted chain rounds as the sequential loop's.
    `_masked_residuals` takes batched poses. Returns (R, t, chi2)
    tensors."""
    R, t = T_init.R, T_init.t
    dev, f32 = R.device, torch.float32
    K = MAX_TRIALS

    def weigh(R, t):
        r, mask, aux = _masked_residuals(R, t)
        s = torch.sum(r * r, dim=-1)
        w = weights * pseudo_huber_weight(s, huber_delta) * mask
        return r, mask, aux, w * s, w

    def evaluate(R, t):
        """chi2, H, b at one pose."""
        r, mask, aux, ws, w = weigh(R, t)
        J = torch.where(mask[..., None, None], jacobian(aux), 0.0)
        Jw = J * w[..., None, None]
        return (torch.sum(ws), torch.einsum("nij,nik->jk", Jw, J),
                torch.einsum("nij,ni->j", Jw, r))

    def chi2_batch(R, t):
        """chi2 at each of a batch of poses, each summed as a single pose's
        (a batched reduction rounds differently)."""
        ws = weigh(R, t)[3]
        return torch.stack([torch.sum(x) for x in ws])

    chi2, H, b = evaluate(R, t)
    # device fills: a host-built tensor would sync the stream
    mu = torch.full((), 0.01, dtype=f32, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    stop = torch.zeros((), dtype=torch.bool, device=dev)
    eps = 1e-12 * torch.eye(6, dtype=f32, device=dev)
    early = lm_exits_early(dev)
    # nu is 2 at the start of every iteration (an accept resets it), so
    # the k-th retry's damping is mu * nu_0 * ... * nu_(k-1) =
    # mu 2^(k(k+1)/2): powers of two, exact as the twin's products
    k_idx = torch.arange(K, device=dev)
    scale = 2.0 ** (k_idx * (k_idx + 1) // 2).to(f32)
    for _ in range(MAX_ITERS):
        active = (it < MAX_ITERS) & ~stop
        mus = mu * scale  # (K,)
        Hd = H + mus[:, None, None] * torch.diag(torch.diag(H)) + eps
        # one factorization per retry: the batched solve on CUDA (MAGMA)
        # allocates device memory, which a CUDA graph capture refuses
        x = []
        for Hk in Hd:
            L, info = torch.linalg.cholesky_ex(Hk)
            xk = torch.cholesky_solve(b[:, None], L)[:, 0]
            x.append(torch.where(torch.isfinite(xk) & (info == 0), xk, 0.0))
        x = torch.stack(x)
        Te = SE3.exp(x)
        gain = chi2 - chi2_batch(Te.R @ R, (Te.R @ t[:, None])[..., 0] + Te.t)
        # the first retry that lowers chi2 (index_select: indexing by a
        # 0-dim tensor would read it on the host)
        k = torch.argmax((gain > 0).to(torch.int32)).reshape(1)

        def pick(a):
            return a.index_select(0, k)[0]

        x_k, gain_k, mu_k = pick(x), pick(gain), pick(mus)
        accept = active & (gain_k > 0)
        # normalized gain ratio for the mu schedule
        denom = torch.clamp(torch.sum(x_k * (mu_k * x_k + b)), min=1e-20)
        mu_acc = mu_k * torch.clamp(1.0 - (2.0 * gain_k / denom - 1.0) ** 3,
                                    min=1.0 / 3.0)
        Te = SE3.exp(x_k)
        R_k, t_k = Te.R @ R, Te.R @ t + Te.t
        chi2_k, H_k, b_k = evaluate(R_k, t_k)
        R = torch.where(accept, R_k, R)
        t = torch.where(accept, t_k, t)
        chi2 = torch.where(accept, chi2_k, chi2)
        H = torch.where(accept, H_k, H)
        b = torch.where(accept, b_k, b)
        mu = torch.where(accept, mu_acc, mu)
        it = torch.where(accept, it + 1, it)
        # no retry lowering chi2 is the twin's stop after MAX_TRIALS
        # rejections in a row
        stop = torch.where(accept, torch.max(torch.abs(x_k)) <= 1e-10,
                           stop | active)
        if early and bool(stop | (it >= MAX_ITERS)):
            break
    return R, t, chi2


def motion_only_ba(cam: StereoCamera, T_init: SE3, xyz_w, obs_uvu, weights,
                   valid, huber_delta: float = 1.0) -> MotionOnlyResult:
    """The robust LM over the stereo (uvu) residuals, a fixed-trip device
    loop (`_lm_pose_fixed`): no host read."""
    residuals_of = _stereo_residuals(cam, xyz_w, obs_uvu, valid)
    R, t, chi2 = _lm_pose_fixed(residuals_of, lambda y: _jac(cam, y), T_init,
                                weights, huber_delta)
    residuals, inliers, _ = residuals_of(R, t)
    return MotionOnlyResult(SE3(R, t), chi2, torch.sum(valid.to(torch.int32)),
                            residuals, inliers)


def motion_only_ba_uv(cam_params, T_init: SE3, xyz_w, obs_uv, weights, valid,
                      huber_delta: float = 1.0) -> MotionOnlyResult:
    """Monocular motion-only BA: the robust LM over 2-component uv
    residuals (the MONO-typedef'd BA_SE3_XYZ optimizer,
    pose_optimizer.h:489-495), `cam_params` = (focal, ppx, ppy). A
    fixed-trip device loop (`_lm_pose_fixed`): no host read."""
    focal, ppx, ppy = cam_params

    def _masked_residuals(R, t):
        pred, y, z = _predict_uv(focal, ppx, ppy, R, t, xyz_w)
        r = obs_uv - pred
        mask = valid & (z > 0.1) & torch.all(torch.isfinite(r), dim=-1)
        r = torch.where(mask[..., None], r, torch.zeros_like(r))
        return r, mask, y

    R, t, chi2 = _lm_pose_fixed(_masked_residuals, lambda y: _jac_uv(focal, y),
                                T_init, weights, huber_delta)
    residuals, inliers, _ = _masked_residuals(R, t)
    return MotionOnlyResult(SE3(R, t), chi2, torch.sum(valid.to(torch.int32)),
                            residuals, inliers)


def motion_only_ba_robust(cam: StereoCamera, T_init: SE3, xyz_w, obs_uvu,
                          weights, valid, huber_delta: float = 1.0,
                          reject_thresh: float = 3.0, rounds: int = 2
                          ) -> MotionOnlyResult:
    """LM + outlier rejection: optimize, drop obs with max-component residual
    above ``reject_thresh`` pixels, re-optimize. Each round is the
    fixed-trip device loop, so the whole call runs without a host sync."""
    res = motion_only_ba(cam, T_init, xyz_w, obs_uvu, weights, valid,
                         huber_delta)
    keep = valid
    for _ in range(rounds - 1):
        keep = (keep & res.inlier_mask
                & (torch.amax(torch.abs(res.residuals), dim=-1) < reject_thresh))
        res = motion_only_ba(cam, res.T, xyz_w, obs_uvu, weights, keep,
                             huber_delta)
    return res


class PointFilterResult(NamedTuple):
    psi: torch.Tensor  # (N, 3) updated inverse-depth points
    Lambda: torch.Tensor  # (N, 3, 3) updated information
    res: torch.Tensor  # (N,) final cost (reprojection + prior Mahalanobis)


def filter_points_info(cam_params, R_ca, t_ca, psi, Lambda, obs_uv, valid,
                       iters: int = 5) -> PointFilterResult:
    """Batched single-landmark information filter: monocular depth-free
    point initialization (filterSingleFeatureOnly, pose_optimizer.h:300-422;
    Strasdat et al., RSS 2010).

    Per landmark (observing camera R_ca, t_ca from its anchor; psi in the
    anchor frame): LM-minimize ``|obs - proj(T_ca, psi)|^2 + (psi0 - psi)^T
    Lambda (psi0 - psi)`` for `iters` fixed iterations, then add the
    measured information J^T J to Lambda. Invalid rows keep psi and
    Lambda."""
    focal, ppx, ppy = cam_params
    psi0 = psi
    eye3 = torch.eye(3, dtype=psi.dtype, device=psi.device)

    def predict(p):
        q = p[:, 2:3]
        q_safe = torch.where(torch.abs(q) < 1e-9, torch.full_like(q, 1e-9), q)
        xyz_a = torch.cat([p[:, :2], torch.ones_like(q)], -1) / q_safe
        y = torch.einsum("nij,nj->ni", R_ca, xyz_a) + t_ca
        z = y[:, 2]
        z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
        uv = torch.stack([y[:, 0] / z_safe * focal + ppx,
                          y[:, 1] / z_safe * focal + ppy], -1)
        return uv, y, z_safe, q_safe

    def jac(y, z_safe, q_safe, xyz_a_rot):
        # d uv / d psi = Jproj(y) @ d(T psi^-1)/d psi
        zero = torch.zeros_like(z_safe)
        z2 = z_safe * z_safe
        Jproj = torch.stack([
            torch.stack([focal / z_safe, zero, -focal * y[:, 0] / z2], -1),
            torch.stack([zero, focal / z_safe, -focal * y[:, 1] / z2], -1),
        ], -2)  # (N, 2, 3)
        inner = torch.stack([R_ca[..., :, 0], R_ca[..., :, 1], -xyz_a_rot],
                            -1) / q_safe[:, :, None]
        return Jproj @ inner  # (N, 2, 3)

    def jacobian(p):
        uv, y, z_safe, q_safe = predict(p)
        bearing = torch.cat([p[:, :2], torch.ones_like(p[:, :1])], -1) / q_safe
        return uv, jac(y, z_safe, q_safe,
                       torch.einsum("nij,nj->ni", R_ca, bearing))

    def cost(p):
        uv = predict(p)[0]
        r = obs_uv - uv
        d = psi0 - p
        prior = torch.einsum("ni,nij,nj->n", d, Lambda, d)
        return torch.sum(r * r, -1) + prior

    res = cost(psi)
    mu = torch.full(psi.shape[:1], 0.01, dtype=psi.dtype, device=psi.device)
    nu = torch.full(psi.shape[:1], 2.0, dtype=psi.dtype, device=psi.device)
    p_cur = psi
    for _ in range(iters):
        uv, J = jacobian(p_cur)
        r_cur = obs_uv - uv
        V = torch.einsum("nki,nkj->nij", J, J)
        g = (torch.einsum("nki,nk->ni", J, r_cur)
             + torch.einsum("nij,nj->ni", Lambda, psi0 - p_cur))
        H = Lambda + V + mu[:, None, None] * eye3
        p_new = p_cur + torch.einsum("nij,nj->ni", _inv3x3(H), g)
        res_new = cost(p_new)
        accept = (res_new < res) & valid & torch.all(torch.isfinite(p_new), -1)
        p_cur = torch.where(accept[:, None], p_new, p_cur)
        res = torch.where(accept, res_new, res)
        mu = torch.where(accept, mu / 3.0, mu * nu)
        nu = torch.where(accept, 2.0, nu * 2.0)

    # Lambda += V at the converged point (the information update)
    _, J = jacobian(p_cur)
    V = torch.einsum("nki,nkj->nij", J, J)
    return PointFilterResult(
        torch.where(valid[:, None], p_cur, psi),
        torch.where(valid[:, None, None], Lambda + V, Lambda),
        res,
    )

"""Dense photometric tracking (port of scavislam_tpu.models.dense_tracker).

Coarse-to-fine Levenberg-Marquardt on the clamped photometric residual
between the previous frame's back-projected cloud and the current image:
- residual r = I_ref - I_cur(pi(T x)), clamped to [-0.1, 0.1], 2-px border;
- multiplicative damping H += mu * diag(H); accept if chi2 drops; mu *=
  max(1/3, 1-(2*rho-1)^3) on success, mu *= nu, nu *= 2 on failure; at most
  MAX_TRIALS failed trials in a row, MAX_ITERS accepted steps.

Two forms, as in the twin:
- inverse compositional (``_lm_level_ic``, the frame step's): the template
  Jacobian is computed once per cloud (``template_jacobian``) and the update
  is T <- T exp(-d);
- forward compositional (``_lm_level``, behind the public
  ``dense_tracking``): the residual Jacobian is rebuilt from the sampled
  gradients at every pose and the update is T <- exp(x) T.
Both LMs run as MAX_ITERS * MAX_TRIALS masked trips on the device (the
bound on the twin's ``lax.while_loop``), with a Cholesky that reports
failure instead of raising: no host read, so the frame step captures into
a CUDA graph. On the CPU they leave the loop at the twin's stop
(``lm_exits_early``), bit for bit the same result, except in the lanes of a
batched program (``lanes``: the multistream steps' vmap over streams),
where the stop differs per stream.

The inverse-compositional evaluation (``_ic_pass``: H, b and chi2 at a
candidate pose) is ``ops.dense_ic``'s: its plain version on the CPU, one
hand-written CUDA kernel call on a card (batched over the streams under
vmap). Bilinear sampling has the exact semantics of the twin's
``_sample_qpack`` (clamped base, fractions from the clamped base). The twin's tap packing
(``_qpack``, ``_sample_qpack``) and its bf16 matrix-unit sampler
(``_sample_matmul``) are TPU workarounds for transaction-bound gathers and
are not ported, nor their tests.

``compute_dense_point_cloud`` and ``cloud_pyramid_from_disparity``
back-project a disparity map into an anchor frame, whole or per level.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple

import numpy as np
import torch

from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.core.lie import SE3
from scavislam_tpu_torch.ops import dense_ic
from scavislam_tpu_torch.ops.dense_ic import RES_CLAMP, in_frame, project
from scavislam_tpu_torch.ops.image import bilinear_sample

MAX_ITERS = 15
MAX_TRIALS = 2


class DenseTrackingResult(NamedTuple):
    T: SE3
    chi2: torch.Tensor  # per level, (levels,)
    iters: torch.Tensor  # accepted steps per level, (levels,)


def _residuals(cam, img, R, t, xyz_ref, i_ref, valid):
    """Clamped photometric residuals, in-frame mask, current-frame points
    and their pixels, for all reference points."""
    xyz_cur = xyz_ref @ R.T + t
    z, uv = project(cam.focal, cam.pp, xyz_cur)
    w, h = cam.size
    inside = in_frame(uv, z, w, h, valid)
    i_cur, _ = bilinear_sample(img, uv)
    res = torch.clamp(i_ref - i_cur, -RES_CLAMP, RES_CLAMP)
    return (torch.where(inside, res, torch.zeros_like(res)), inside,
            xyz_cur, uv)


def _chi2(cam, img, R, t, xyz_ref, i_ref, valid):
    res, _, _, _ = _residuals(cam, img, R, t, xyz_ref, i_ref, valid)
    return torch.sum(res * res)


def _normal_equations(cam, img, dx_img, dy_img, R, t, xyz_ref, i_ref, valid):
    """(H, b, chi2) = (J^T J, J^T r, r^T r) at pose (R, t), the residual
    Jacobian from the gradients sampled at the current pixels (Sobel with
    its 1/8 scale: the true centred-difference gradient, no extra factor)."""
    res, inside, xyz_cur, uv = _residuals(cam, img, R, t, xyz_ref, i_ref,
                                          valid)
    dx = bilinear_sample(dx_img, uv)[0]
    dy = bilinear_sample(dy_img, uv)[0]
    j0, j1 = _proj_pose_jac(cam.focal, xyz_cur)
    # r = I_ref - I_cur(uv(T x))  =>  dr/dxi = -grad I . duv/dxi
    J = -(dx[..., None] * j0 + dy[..., None] * j1)
    J = torch.where(inside[..., None], J, torch.zeros_like(J))
    return J.T @ J, J.T @ res, torch.sum(res * res)


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


def _ic_pass(cam, img, R, t, xyz_ref, i_ref, J_ref, valid):
    """One inverse-compositional evaluation at pose (R, t): masked
    (H, b, chi2) with the fixed template Jacobian (``ops.dense_ic``: the
    plain version on the CPU, the CUDA kernels on a card)."""
    return dense_ic.ic_pass(img, R, t, xyz_ref, i_ref, J_ref, valid,
                            cam.focal, cam.pp)


def to_device_pose(R: np.ndarray, t: np.ndarray, device) -> SE3:
    """Upload a host pose in ONE transfer (asynchronous from pinned memory
    on a CUDA device)."""
    buf = torch.from_numpy(np.concatenate([R.reshape(-1), t]).astype(np.float32))
    if device.type == "cuda":
        buf = buf.pin_memory().to(device, non_blocking=True)
    return SE3(buf[:9].reshape(3, 3), buf[9:])


# the fixed-trip LMs leave their loop at the twin's stop on the CPU, where
# reading the flag costs nothing (every later trip would change nothing);
# on a card they run every trip, so that they enqueue, and capture into a
# CUDA graph, without a host read
EARLY_EXIT_ON_CPU = True


# set while a caller runs the LMs as lanes of a program vmapped over
# streams (parallel.multistream)
_LANES = contextvars.ContextVar("lanes", default=False)


@contextlib.contextmanager
def lanes():
    """The LMs called in the body run as lanes of a program that the
    caller vmaps over streams: every trip (the stop differs per lane),
    and on a card with a capturable batched solve (``cho_solve``)."""
    token = _LANES.set(True)
    try:
        yield
    finally:
        _LANES.reset(token)


def lm_exits_early(device: torch.device) -> bool:
    """Whether a fixed-trip LM on `device` reads its stop flag after each
    trip and leaves the loop once the twin's loop would have ended. Never
    in ``lanes``: the flag holds one value per stream there, and the LM
    runs every trip, as on a card."""
    return EARLY_EXIT_ON_CPU and device.type == "cpu" and not _LANES.get()


def cho_solve(b: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """``torch.cholesky_solve(b, L)``. In ``lanes`` on a CUDA device, two
    triangular solves instead: vmap batches the solve, and the batched
    ``cholesky_solve`` there runs MAGMA, which allocates device memory and
    so breaks a CUDA graph capture."""
    if L.is_cuda and _LANES.get():
        return _triangular_solves(b, L)
    return torch.cholesky_solve(b, L)


def _triangular_solves(b, L):
    """x with L L^T x = b: forward, then back substitution."""
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def _lm_level_ic(cam, img, xyz_ref, i_ref, J_ref, valid, R0, t0,
                 max_iters=MAX_ITERS):
    """Inverse-compositional LM for one pyramid level, on the device with no
    host read. Returns (R, t, chi2, iters) tensors.

    The twin's while_loop body (deferred acceptance: each trip evaluates
    the CANDIDATE pose T exp(-d) and compares its chi2 with the
    incumbent's; an accept carries the candidate's H and b over, a reject
    keeps the incumbent's; the mu rule on the un-normalized gain) as
    max_iters * MAX_TRIALS masked trips: at most MAX_TRIALS - 1 rejections
    come before each of max_iters accepts, so the twin runs no more bodies,
    and a trip past its stop changes nothing. The damped 6x6 system is one
    unbatched Cholesky that reports failure instead of raising; a failed
    factorization or a non-finite step gives 0, the twin's NaN guard."""
    dev, f32 = img.device, torch.float32
    H, b, chi2 = _ic_pass(cam, img, R0, t0, xyz_ref, i_ref, J_ref, valid)
    R, t = R0, t0
    # device fills: a host-built tensor would sync the stream
    mu = torch.full((), 0.01, dtype=f32, device=dev)
    nu = torch.full((), 2.0, dtype=f32, device=dev)
    trial = torch.zeros((), dtype=torch.int32, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    stop = torch.zeros((), dtype=torch.bool, device=dev)
    eps = 1e-12 * torch.eye(6, dtype=f32, device=dev)
    early = lm_exits_early(dev)
    for _ in range(max_iters * MAX_TRIALS):
        active = (it < max_iters) & ~stop
        Hd = H + mu * torch.diag(torch.diag(H)) + eps
        L, info = torch.linalg.cholesky_ex(Hd)
        d = cho_solve(-b[:, None], L)[:, 0]
        d = torch.where(torch.isfinite(d) & (info == 0), d, 0.0)
        Te = SE3.exp(-d)
        R_new, t_new = R @ Te.R, R @ Te.t + t
        H_new, b_new, chi2_new = _ic_pass(cam, img, R_new, t_new, xyz_ref,
                                          i_ref, J_ref, valid)
        rho = chi2 - chi2_new
        accept = active & (rho > 0)
        reject = active & ~(rho > 0)
        stop_acc = torch.max(torch.abs(d)) <= 1e-5
        mu_acc = mu * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        trial_new = torch.where(accept, 0, trial + 1)
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        H = torch.where(accept, H_new, H)
        b = torch.where(accept, b_new, b)
        chi2 = torch.where(accept, chi2_new, chi2)
        mu = torch.where(accept, mu_acc, torch.where(reject, mu * nu, mu))
        nu = torch.where(accept, 2.0, torch.where(reject, nu * 2.0, nu))
        trial = torch.where(active, trial_new, trial)
        it = torch.where(accept, it + 1, it)
        stop = torch.where(active, torch.where(accept, stop_acc,
                                               trial_new >= MAX_TRIALS), stop)
        if early and bool(stop | (it >= max_iters)):
            break
    return R, t, chi2, it


def _lm_level(cam, img, dx_img, dy_img, xyz_ref, i_ref, valid, R0, t0):
    """Forward-compositional LM for one pyramid level, on the device with no
    host read. Returns (R, t, chi2, iters) tensors.

    The twin's deferred acceptance: each trip linearizes at the CANDIDATE
    pose and compares its chi2 with the incumbent's; an accept carries the
    candidate's H and b over, a reject keeps the incumbent's. The twin's
    while_loop becomes MAX_ITERS * MAX_TRIALS trips (at most MAX_TRIALS - 1
    rejections before each of MAX_ITERS accepts); a trip past the loop's end
    changes nothing."""
    dev, f32 = img.device, torch.float32
    H, b, chi2 = _normal_equations(cam, img, dx_img, dy_img, R0, t0, xyz_ref,
                                   i_ref, valid)
    R, t = R0, t0
    # device fills: a host-built tensor would sync the stream
    mu = torch.full((), 0.01, dtype=f32, device=dev)
    nu = torch.full((), 2.0, dtype=f32, device=dev)
    trial = torch.zeros((), dtype=torch.int32, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    stop = torch.zeros((), dtype=torch.bool, device=dev)
    eps = 1e-12 * torch.eye(6, dtype=f32, device=dev)
    early = lm_exits_early(dev)
    for _ in range(MAX_ITERS * MAX_TRIALS):
        active = (it < MAX_ITERS) & ~stop
        Hd = H + mu * torch.diag(torch.diag(H)) + eps
        L, info = torch.linalg.cholesky_ex(Hd)
        x = cho_solve(-b[:, None], L)[:, 0]
        x = torch.where(torch.isfinite(x) & (info == 0), x, 0.0)
        Te = SE3.exp(x)
        R_new, t_new = Te.R @ R, Te.R @ t + Te.t
        H_new, b_new, chi2_new = _normal_equations(
            cam, img, dx_img, dy_img, R_new, t_new, xyz_ref, i_ref, valid)
        rho = chi2 - chi2_new
        accept = active & (rho > 0)
        reject = active & ~(rho > 0)
        # convergence at 1e-5 (a sub-0.01-pixel step)
        stop_acc = torch.max(torch.abs(x)) <= 1e-5
        mu_acc = mu * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        trial_new = torch.where(accept, 0, trial + 1)
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        H = torch.where(accept, H_new, H)
        b = torch.where(accept, b_new, b)
        chi2 = torch.where(accept, chi2_new, chi2)
        mu = torch.where(accept, mu_acc, torch.where(reject, mu * nu, mu))
        nu = torch.where(accept, 2.0, torch.where(reject, nu * 2.0, nu))
        trial = torch.where(active, trial_new, trial)
        it = torch.where(accept, it + 1, it)
        stop = torch.where(active, torch.where(accept, stop_acc,
                                               trial_new >= MAX_TRIALS), stop)
        if early and bool(stop | (it >= MAX_ITERS)):
            break
    return R, t, chi2, it


def dense_tracking(frame, ref_clouds, ref_intensities, ref_valids,
                   cam_pyramid, T_init: SE3) -> DenseTrackingResult:
    """Estimate T_cur_from_actkey, coarse to fine.

    frame: {"pyr", "dx", "dy"} of the current frame (ops.image.
    preprocess_frame); ref_clouds / ref_intensities / ref_valids: per-level
    (N_l, 3) points in the anchor frame, (N_l,) intensities and masks;
    cam_pyramid: one StereoCamera per level."""
    R, t = T_init.R, T_init.t
    chi2s, iters = [], []
    for level in range(len(frame["pyr"]) - 1, -1, -1):
        R, t, chi2, it = _lm_level(
            cam_pyramid[level], frame["pyr"][level], frame["dx"][level],
            frame["dy"][level], ref_clouds[level], ref_intensities[level],
            ref_valids[level], R, t)
        chi2s.append(chi2)
        iters.append(it)
    return DenseTrackingResult(SE3(R, t), torch.stack(chi2s[::-1]),
                               torch.stack(iters[::-1]))


# -- dense point cloud ---------------------------------------------------------

def _backproject(d, cam: StereoCamera, stride: int):
    """Every pixel of the (decimated) disparity map d -> ((N, 3) xyz in the
    camera frame, (N,) valid = d > 0); pixel (v, u) of d sits at (v, u) *
    stride in `cam`'s image."""
    h, w = d.shape
    v_idx = torch.arange(h, dtype=torch.float32, device=d.device)[:, None] * stride
    u_idx = torch.arange(w, dtype=torch.float32, device=d.device)[None, :] * stride
    valid = d > 0.0
    xyz = cam.uv_disp_to_xyz(u_idx, v_idx,
                             torch.where(valid, d, torch.ones_like(d)))
    return xyz.reshape(-1, 3), valid.reshape(-1)


def compute_dense_point_cloud(disp: torch.Tensor, cam: StereoCamera,
                              T_cur_from_actkey: SE3, stride: int = 1):
    """Back-project every `stride`-th pixel of a level-0 disparity map (<= 0
    invalid) into the active keyframe's frame: xyz_actkey = T^-1 *
    unproject(u, v, disp). Returns (xyz (N, 3), valid (N,)), N = (H/stride)
    * (W/stride)."""
    xyz, valid = _backproject(disp[::stride, ::stride], cam, stride)
    return T_cur_from_actkey.inverse().apply(xyz), valid


def cloud_pyramid_from_disparity(disp0: torch.Tensor, cam0: StereoCamera,
                                 T: SE3, levels: int = 3):
    """Per-level clouds for the tracker: level l back-projects the level-0
    disparity decimated by 2^l with the level-l camera (its values are
    level-invariant: the level cameras double the baseline). Returns (clouds,
    valids) tuples."""
    clouds, valids = [], []
    Tinv = T.inverse()
    for level in range(levels):
        s = 2**level
        xyz, valid = _backproject(disp0[::s, ::s], cam0.scale_level(level), 1)
        clouds.append(Tinv.apply(xyz))
        valids.append(valid)
    return tuple(clouds), tuple(valids)

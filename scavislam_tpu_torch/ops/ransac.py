"""Batched RANSAC for SE3 / Sim3 absolute orientation (port of
scavislam_tpu.ops.ransac).

The model is Horn/Arun closed-form absolute orientation from 3 point
correspondences (ransac_models.cpp:44-81), scored by per-component uvu
reprojection error (ransac_models.cpp:27-42); all M hypotheses are estimated
and scored at once, degenerate samples masked rather than redrawn.

Each RANSAC is split in two: :func:`draw_hypotheses` draws the raw (M, 3)
sample indices in [0, N) from an explicit ``torch.Generator``, and the
scorer (:func:`ransac_se3`, :func:`ransac_sim3`) takes them. The twin draws
with ``jax.random.randint``, whose stream no torch generator reproduces, so
a caller that wants the twin's exact hypotheses passes the twin's indices.

The rotation of each fit comes from a fixed-sweep one-sided Jacobi SVD of
the 3x3 cross-covariance (:func:`_rotation_from_cross_cov`) instead of
``torch.linalg.svd``: on a card the latter reads its convergence flag back
to the host after every call, and the geometric check must not stop the
host. R is built from the two leading singular pairs, which is the twin's
``V diag(1, 1, sign(det(V U^T))) U^T`` without the sign term (that
determinant of two orthogonal factors is +-1).
"""

from __future__ import annotations

import torch

from scavislam_tpu_torch.core.lie import SE3

# one-sided Jacobi sweeps over the 3 column pairs of a 3x3 matrix; the
# rotation converges quadratically: against a float64 LAPACK SVD, 3 sweeps
# already give R within f32 rounding (median 1.3e-7) on random rank-2 and
# rank-3 inputs; one more for margin
_JACOBI_SWEEPS = 4
_PAIRS = ((0, 1), (0, 2), (1, 2))


def _rotation_from_cross_cov(H: torch.Tensor) -> torch.Tensor:
    """The Kabsch / Horn rotation R (..., 3, 3) of the cross-covariance
    H = sum a_c b_c^T (B ~ R A): for H = U S V^T, R maps u_i -> v_i, and
    R = v1 u1^T + v2 u2^T + (v1 x v2)(u1 x u2)^T.

    H's columns are rotated by Jacobi rotations until they are orthogonal:
    H W = U S with W = V. A singular value at 0 (an all-zero H) takes
    u_i = v_i, so the zero matrix gives the identity, as the twin's SVD
    does."""
    A = H.clone()
    # a device fill: writing Python scalars into elements of a CUDA tensor
    # would copy each from the host and wait
    V = torch.eye(3, dtype=H.dtype, device=H.device).expand(H.shape).clone()
    for _ in range(_JACOBI_SWEEPS):
        for p, q in _PAIRS:
            ap, aq = A[..., :, p], A[..., :, q]
            alpha = torch.sum(ap * ap, dim=-1)
            beta = torch.sum(aq * aq, dim=-1)
            gamma = torch.sum(ap * aq, dim=-1)
            still = gamma == 0.0
            zeta = (beta - alpha) / (2.0 * torch.where(still, 1.0, gamma))
            sgn = torch.where(zeta >= 0.0, 1.0, -1.0)
            t = sgn / (torch.abs(zeta) + torch.sqrt(1.0 + zeta * zeta))
            t = torch.where(still, 0.0, t)
            c = torch.rsqrt(1.0 + t * t)[..., None]
            s = c * t[..., None]
            for M in (A, V):
                mp, mq = M[..., :, p], M[..., :, q]
                new_p = c * mp - s * mq
                new_q = s * mp + c * mq
                M[..., :, p] = new_p
                M[..., :, q] = new_q
    sigma = torch.linalg.vector_norm(A, dim=-2)  # (..., 3)
    order = torch.argsort(-sigma, dim=-1, stable=True)[..., None, :]
    order = order.expand(A.shape)
    A = torch.gather(A, -1, order)
    V = torch.gather(V, -1, order)
    sigma = torch.gather(sigma, -1, order[..., 0, :])
    U = torch.where(sigma[..., None, :] > 1e-30,
                    A / torch.clamp(sigma, min=1e-30)[..., None, :], V)
    u1, u2 = U[..., :, 0], U[..., :, 1]
    v1, v2 = V[..., :, 0], V[..., :, 1]
    u3 = torch.linalg.cross(u1, u2)
    v3 = torch.linalg.cross(v1, v2)
    return (v1[..., :, None] * u1[..., None, :]
            + v2[..., :, None] * u2[..., None, :]
            + v3[..., :, None] * u3[..., None, :])


def _horn_abs_orientation(A: torch.Tensor, B: torch.Tensor):
    """R, t with B ~ R A + t for point triplets A, B (..., 3, 3), each row a
    point; batched over the leading dims."""
    ca = torch.mean(A, dim=-2)
    cb = torch.mean(B, dim=-2)
    H = (A - ca[..., None, :]).transpose(-1, -2) @ (B - cb[..., None, :])
    R = _rotation_from_cross_cov(H)
    t = cb - (R @ ca[..., :, None])[..., 0]
    return R, t


def _horn_sim3(A: torch.Tensor, B: torch.Tensor):
    """s, R, t with B ~ s R A + t (Horn absolute orientation with the
    standard centred scale; parity surface: Sim3Model::calc_motion,
    ransac_models.cpp:85-136, whose uncentred scale the twin does not
    reproduce either)."""
    ca = torch.mean(A, dim=-2)
    cb = torch.mean(B, dim=-2)
    Ac, Bc = A - ca[..., None, :], B - cb[..., None, :]
    R = _rotation_from_cross_cov(Ac.transpose(-1, -2) @ Bc)
    na = torch.sum(Ac * Ac, dim=(-1, -2))
    nb = torch.sum(Bc * Bc, dim=(-1, -2))
    s = torch.sqrt(nb / torch.clamp(na, min=1e-12))
    t = cb - s[..., None] * (R @ ca[..., :, None])[..., 0]
    return s, R, t


def draw_hypotheses(n: int, num_hypotheses: int = 256,
                    generator: torch.Generator = None,
                    device=None) -> torch.Tensor:
    """Raw sample indices (num_hypotheses, 3) in [0, n), int64, from
    `generator` (on `device`); the scorers map them onto the valid
    entries."""
    return torch.randint(0, n, (num_hypotheses, 3), generator=generator,
                         device=device)


def _samples(idx: torch.Tensor, valid: torch.Tensor):
    """Raw draws -> indices of valid points (drawn from the valid-compacted
    range, valid entries first in a stable order) and the degenerate mask
    (a repeated index)."""
    nv = torch.clamp(torch.sum(valid), min=1)
    order = torch.argsort((~valid).to(torch.int32), stable=True)
    idx = order[torch.remainder(idx, nv)]
    degenerate = ((idx[:, 0] == idx[:, 1]) | (idx[:, 0] == idx[:, 2])
                  | (idx[:, 1] == idx[:, 2]))
    return idx, degenerate


def _uvu(xyz: torch.Tensor, cam_params):
    focal, ppx, ppy, baseline = cam_params
    z = xyz[..., 2]
    z = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    u = xyz[..., 0] / z * focal + ppx
    v = xyz[..., 1] / z * focal + ppy
    ur = (xyz[..., 0] - baseline) / z * focal + ppx
    return torch.stack([u, v, ur], dim=-1)


def _score(pred_fn, xyz_b, valid, degenerate, cam_params, inlier_thr):
    """Per-hypothesis inlier masks and counts, and the first best
    hypothesis's index as a (1,) tensor (no host read)."""
    obs = _uvu(xyz_b, cam_params)  # (N, 3)
    pred = _uvu(pred_fn(), cam_params)  # (M, N, 3)
    err_ok = torch.all(torch.abs(obs[None] - pred) < inlier_thr, dim=-1)
    err_ok = err_ok & valid[None, :] & (~degenerate)[:, None]
    counts = torch.sum(err_ok, dim=1)
    best = torch.argmax(counts).reshape(1)
    return err_ok, counts, best


def ransac_se3(idx: torch.Tensor, xyz_a: torch.Tensor, xyz_b: torch.Tensor,
               valid: torch.Tensor, cam_params, inlier_thr: float = 3.0):
    """Estimate T_b_from_a from the hypotheses `idx` (M, 3) (raw draws in
    [0, N), :func:`draw_hypotheses`). Returns (R, t, inlier_mask,
    num_inliers) of the first hypothesis with the most inliers, as device
    tensors.

    Scoring parity: inlier iff |uvu_obs - uvu(R a + t)| < thr per component
    (ransac_models.cpp:27-42), uvu_obs the projection of xyz_b."""
    idx, degenerate = _samples(idx, valid)
    R_h, t_h = _horn_abs_orientation(xyz_a[idx], xyz_b[idx])
    err_ok, counts, best = _score(
        lambda: torch.einsum("mij,nj->mni", R_h, xyz_a) + t_h[:, None, :],
        xyz_b, valid, degenerate, cam_params, inlier_thr)
    return R_h[best][0], t_h[best][0], err_ok[best][0], counts[best][0]


def ransac_sim3(idx: torch.Tensor, xyz_a: torch.Tensor, xyz_b: torch.Tensor,
                valid: torch.Tensor, cam_params, inlier_thr: float = 3.0):
    """Estimate the Sim3 S_b_from_a (monocular loop closure needs the scale
    dof) from the hypotheses `idx` (M, 3). Returns (s, R, t, inlier_mask,
    num_inliers)."""
    idx, degenerate = _samples(idx, valid)
    s_h, R_h, t_h = _horn_sim3(xyz_a[idx], xyz_b[idx])
    err_ok, counts, best = _score(
        lambda: (s_h[:, None, None]
                 * torch.einsum("mij,nj->mni", R_h, xyz_a)
                 + t_h[:, None, :]),
        xyz_b, valid, degenerate, cam_params, inlier_thr)
    return (s_h[best][0], R_h[best][0], t_h[best][0], err_ok[best][0],
            counts[best][0])


def refine_se3_from_inliers(xyz_a: torch.Tensor, xyz_b: torch.Tensor,
                            inliers: torch.Tensor) -> SE3:
    """Weighted Horn/Arun over ALL inliers (least-squares polish)."""
    w = inliers.to(torch.float32)[:, None]
    sw = torch.clamp(torch.sum(w), min=1e-6)
    ca = torch.sum(xyz_a * w, dim=0) / sw
    cb = torch.sum(xyz_b * w, dim=0) / sw
    H = ((xyz_a - ca) * w).T @ (xyz_b - cb)
    R = _rotation_from_cross_cov(H)
    return SE3(R, cb - R @ ca)

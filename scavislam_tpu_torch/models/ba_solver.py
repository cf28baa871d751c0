"""Batched Schur-complement bundle adjustment + pose graph (port of
scavislam_tpu.models.ba_solver).

A Levenberg-Marquardt optimizer over
- double-window keyframe poses (inner + outer),
- active points in anchored inverse-depth parametrization psi = (x/z, y/z,
  1/z) with ternary factors (point, observer pose, anchor pose),
- relative-pose binary edges with 6x6 information matrices.

The problem is laid out as fixed-capacity arrays and the solve is dense
blocked, as in the twin:

  1. all observation residuals/Jacobians in one batched pass;
  2. H_pp (3x3 point blocks) by scatter-add, inverted in closed form;
  3. H_cc (6x6 pose blocks on a dense (P, P) grid) by scatter-add of the
     per-observation 12x12 blocks into a flat (P*P, 6, 6) (the twin's
     one-hot einsums are a TPU layout trick);
  4. the Schur complement S = H_cc - W H_pp^-1 W^T as one large matmul
     ((P*6, L*3) @ (L*3, P*6));
  5. a dense Cholesky of S on the device (`cholesky_ex`: no host sync, NaN
     guarded to 0 as the twin's `cho_solve` result is); back-substitution
     for the point updates.

The LM loop runs `iters` rounds with masked accepts and no host read.
Observation weighting: diag(4^-level, 4^-level, 0.333^2); Huber width 3;
initial lambda 50.

With ``sp_axis`` (a parallel.mesh.MeshAxis: the shard group, not a name)
the observation axis is split into one contiguous chunk per device of the
axis: each shard builds the partial H, b and chi2 of its chunk (the
replicated edges count on shard 0 only, as in the twin), the partials are
summed in shard order on shard 0's device, and the LM runs on the summed
system there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scavislam_tpu_torch.core.lie import SE3, ad_se3, hat

# default capacities (one BA window)
NUM_POSES = 128
NUM_POINTS = 2048
NUM_OBS = 8192
NUM_EDGES = 512


class BAProblem(NamedTuple):
    """Fixed-capacity double-window BA problem (all tensors on one device)."""

    R: torch.Tensor  # (P, 3, 3) T_kw rotations
    t: torch.Tensor  # (P, 3)
    pose_valid: torch.Tensor  # (P,) slot holds a pose
    pose_fixed: torch.Tensor  # (P,) pose held constant

    psi: torch.Tensor  # (L, 3) inverse-depth in anchor frame
    anchor_slot: torch.Tensor  # (L,) int32 pose slot of the anchor
    point_valid: torch.Tensor  # (L,)

    obs_pose: torch.Tensor  # (O,) int32 observer pose slot
    obs_point: torch.Tensor  # (O,) int32 point index
    obs_uvu: torch.Tensor  # (O, 3)
    obs_weight: torch.Tensor  # (O,) scalar info scale (4^-level)
    obs_valid: torch.Tensor  # (O,)

    edge_i: torch.Tensor  # (E,) int32
    edge_j: torch.Tensor  # (E,)
    # the constraint stores T_j_from_i: the residual is
    # d = log(T_ji * T_iw * T_jw^-1), zero iff the relative pose matches
    edge_R: torch.Tensor  # (E, 3, 3)
    edge_t: torch.Tensor  # (E, 3)
    edge_info: torch.Tensor  # (E, 6, 6)
    edge_valid: torch.Tensor  # (E,)

    @staticmethod
    def empty(P=NUM_POSES, L=NUM_POINTS, O=NUM_OBS, E=NUM_EDGES,
              device=None) -> "BAProblem":
        f32, i32, b = torch.float32, torch.int32, torch.bool

        def z(*shape, dtype=f32):
            return torch.zeros(shape, dtype=dtype, device=device)

        def eye(n):
            return torch.eye(3, dtype=f32, device=device).expand(n, 3, 3).clone()

        return BAProblem(
            eye(P), z(P, 3), z(P, dtype=b), z(P, dtype=b),
            z(L, 3), z(L, dtype=i32), z(L, dtype=b),
            z(O, dtype=i32), z(O, dtype=i32), z(O, 3),
            torch.ones((O,), dtype=f32, device=device), z(O, dtype=b),
            z(E, dtype=i32), z(E, dtype=i32), eye(E), z(E, 3), z(E, 6, 6),
            z(E, dtype=b),
        )


class BAStats(NamedTuple):
    chi2_initial: torch.Tensor
    chi2_final: torch.Tensor
    num_obs: torch.Tensor
    num_edges: torch.Tensor


# observation information: diag(4^-level, 4^-level, 0.333^2) — the
# disparity component is not level-scaled. obs_weight carries 4^-level.
_DISP_INFO = 0.333 * 0.333


def _mv(M, x):
    return (M @ x[..., None])[..., 0]


def _obs_residuals(cam_params, prob: BAProblem, R, t, psi):
    """Residuals + masks for every observation (batched)."""
    focal, ppx, ppy, baseline = cam_params
    c = prob.obs_pose.long()
    pidx = prob.obs_point.long()
    a = prob.anchor_slot.long()[pidx]

    psi_o = psi[pidx]
    q = psi_o[:, 2:3]
    q_safe = torch.where(torch.abs(q) < 1e-9, torch.full_like(q, 1e-9), q)
    xyz_a = torch.cat([psi_o[:, :2], torch.ones_like(q)], dim=-1) / q_safe

    R_c, t_c = R[c], t[c]
    R_a, t_a = R[a], t[a]
    # T_ca = T_cw * T_aw^-1
    R_ca = R_c @ R_a.transpose(-1, -2)
    t_ca = t_c - _mv(R_ca, t_a)
    y = _mv(R_ca, xyz_a) + t_ca

    z = y[:, 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    u = y[:, 0] / z_safe * focal + ppx
    v = y[:, 1] / z_safe * focal + ppy
    ur = (y[:, 0] - baseline) / z_safe * focal + ppx
    pred = torch.stack([u, v, ur], dim=-1)
    r = prob.obs_uvu - pred

    mask = (
        prob.obs_valid
        & prob.point_valid[pidx]
        & prob.pose_valid[c]
        & prob.pose_valid[a]
        & (z > 0.1)
        & (q[:, 0] > 1e-9)
        & torch.all(torch.isfinite(r), dim=-1)
    )
    r = torch.where(mask[:, None], r, torch.zeros_like(r))
    return r, mask, (y, R_ca, xyz_a, q_safe[:, 0])


def _edge_residuals(prob: BAProblem, R, t):
    """Relative-pose edge residuals d = log(T_ji * T_iw * T_jw^-1)."""
    i, j = prob.edge_i.long(), prob.edge_j.long()
    R_i, t_i = R[i], t[i]
    R_j, t_j = R[j], t[j]
    # T_iw * T_jw^-1
    R_rel = R_i @ R_j.transpose(-1, -2)
    t_rel = t_i - _mv(R_rel, t_j)
    # T_ij * rel
    R_err = prob.edge_R @ R_rel
    t_err = _mv(prob.edge_R, t_rel) + prob.edge_t
    d = SE3(R_err, t_err).log()
    mask = (
        prob.edge_valid
        & prob.pose_valid[i]
        & prob.pose_valid[j]
        & torch.all(torch.isfinite(d), dim=-1)
    )
    return torch.where(mask[:, None], d, torch.zeros_like(d)), mask


def _huber_weight(s, delta):
    """g2o Huber: weight 1 inside, delta/sqrt(s) outside."""
    return torch.where(s <= delta * delta, torch.ones_like(s),
                       delta / torch.sqrt(torch.clamp(s, min=1e-12)))


def _disp_info_vec(prob, disp_info):
    """Third-component (right-u) information per obs: the stereo default
    0.333^2, or the given vector (zeros = uv-only observations)."""
    if disp_info is None:
        return torch.full_like(prob.obs_weight, _DISP_INFO)
    return disp_info


class _ObsShards:
    """A problem's observation axis split over a mesh axis: shard k holds
    the k-th contiguous chunk of the observations, and copies of the pose,
    point and edge tables, on the axis's k-th device."""

    def __init__(self, prob: BAProblem, axis, disp_info=None):
        self.axis = axis
        self.devices = axis.devices
        n = len(self.devices)
        O = prob.obs_pose.shape[0]
        if O % n:
            raise ValueError(f"obs capacity {O} must divide the "
                             f"{axis.name}-axis size {n}")
        k = O // n
        obs = ("obs_pose", "obs_point", "obs_uvu", "obs_weight", "obs_valid")
        self.probs, self.disp_info = [], []
        for i, d in enumerate(self.devices):
            local = prob._replace(**{f: getattr(prob, f)[i * k:(i + 1) * k]
                                     for f in obs})
            self.probs.append(BAProblem(*(x.to(d) for x in local)))
            self.disp_info.append(None if disp_info is None
                                  else disp_info[i * k:(i + 1) * k].to(d))

    def sum(self, fn, *state):
        """fn(shard, local problem, local disp_info, *state on the shard's
        device) for every shard (all launched first), summed in shard
        order on shard 0's device."""
        parts = [fn(i, p, di, *(x.to(d) for x in state))
                 for i, (d, p, di) in enumerate(zip(
                     self.devices, self.probs, self.disp_info))]
        return self.axis.psum(parts, self.devices[:1])[0]


def _chi2(cam_params, prob, R, t, psi, huber, sp_axis=None, disp_info=None,
          edges=True):
    """chi2 at (R, t, psi); with `sp_axis` (an _ObsShards) summed over the
    shards, the edges counted on shard 0 only."""
    if sp_axis is not None:
        return sp_axis.sum(
            lambda k, p, di, R_, t_, psi_: _chi2(
                cam_params, p, R_, t_, psi_, huber, None, di, edges=k == 0),
            R, t, psi)
    r, mask, _ = _obs_residuals(cam_params, prob, R, t, psi)
    info = torch.stack([prob.obs_weight, prob.obs_weight,
                        _disp_info_vec(prob, disp_info)], dim=-1)
    s = torch.sum(r * r * info, dim=-1)
    w = _huber_weight(s, huber)
    chi_obs = torch.sum(torch.where(mask, w * s, torch.zeros_like(s)))
    if not edges:
        return chi_obs
    d, emask = _edge_residuals(prob, R, t)
    se = torch.einsum("ni,nij,nj->n", d, prob.edge_info, d)
    chi_e = torch.sum(torch.where(emask, se, torch.zeros_like(se)))
    return chi_obs + chi_e


def _build_normal_equations(cam_params, prob: BAProblem, R, t, psi, huber,
                            sp_axis=None, anchor_perm=None, disp_info=None,
                            edges=True):
    """One linearization: dense block H_cc (P, P, 6, 6), W (P, L, 6, 3),
    H_pp (L, 3, 3), gradients g_c (P, 6), g_p (L, 3).

    `anchor_perm` is the twin's sorted-scatter hint for the W blocks; the
    sum is the same up to summation order, so it is accepted and unused.
    With `sp_axis` (an _ObsShards) the shards' partial systems are summed;
    the edges contribute from shard 0 only (`edges`)."""
    del anchor_perm
    if sp_axis is not None:
        return sp_axis.sum(
            lambda k, p, di, R_, t_, psi_: _build_normal_equations(
                cam_params, p, R_, t_, psi_, huber, None, None, di,
                edges=k == 0),
            R, t, psi)
    focal, ppx, ppy, baseline = cam_params
    P = prob.R.shape[0]
    L = prob.psi.shape[0]
    dev = R.device

    r, mask, (y, R_ca, xyz_a, q) = _obs_residuals(cam_params, prob, R, t, psi)
    c = prob.obs_pose.long()
    pidx = prob.obs_point.long()
    a = prob.anchor_slot.long()[pidx]

    # --- Jacobians of the PREDICTION (residual jac = -J), batched
    x_, y_, z_ = y[:, 0], y[:, 1], y[:, 2]
    z_s = torch.where(torch.abs(z_) < 1e-6, torch.full_like(z_, 1e-6), z_)
    z2 = z_s * z_s
    zero = torch.zeros_like(z_)
    Jproj = torch.stack(
        [
            torch.stack([focal / z_s, zero, -focal * x_ / z2], -1),
            torch.stack([zero, focal / z_s, -focal * y_ / z2], -1),
            torch.stack([focal / z_s, zero, -focal * (x_ - baseline) / z2], -1),
        ],
        dim=-2,
    )  # (O, 3, 3)
    eyeO = torch.eye(3, dtype=y.dtype, device=dev).expand(*z_.shape, 3, 3)
    Jexp_y = torch.cat([eyeO, -hat(y)], dim=-1)  # (O, 3, 6)
    Jf = Jproj @ Jexp_y  # d pred / d xi_observer
    Jexp_x = torch.cat([eyeO, -hat(xyz_a)], dim=-1)
    Ja = -(Jproj @ R_ca @ Jexp_x)  # d pred / d xi_anchor
    r1 = R_ca[..., :, 0]
    r2 = R_ca[..., :, 1]
    Rx = _mv(R_ca, xyz_a)
    Jpsi_inner = torch.stack([r1, r2, -Rx], dim=-1) / q[:, None, None]
    Jp = Jproj @ Jpsi_inner  # d pred / d psi (O, 3, 3)

    # --- robust info weights: diag(w_l, w_l, 0.333^2) scaled by Huber
    info = torch.stack([prob.obs_weight, prob.obs_weight,
                        _disp_info_vec(prob, disp_info)], dim=-1)
    s = torch.sum(r * r * info, dim=-1)
    w = _huber_weight(s, huber) * mask
    Winfo = w[:, None] * info  # (O, 3)

    JfW = Jf * Winfo[:, :, None]
    JaW = Ja * Winfo[:, :, None]
    JpW = Jp * Winfo[:, :, None]

    # Hcc: the per-observation 12x12 block of [Jf | Ja] holds the four
    # (observer, anchor) quadrants; scatter-add them into a flat (P*P, 6, 6)
    J12 = torch.cat([Jf, Ja], -1)  # (O, 3, 12)
    J12W = torch.cat([JfW, JaW], -1)
    X12 = torch.einsum("nij,nik->njk", J12W, J12)  # (O, 12, 12)
    Hcc = torch.zeros((P * P, 6, 6), dtype=torch.float32, device=dev)
    Hfa = X12[:, :6, 6:]
    Hcc.index_add_(0, torch.cat([c * P + c, a * P + a, c * P + a, a * P + c]),
                   torch.cat([X12[:, :6, :6], X12[:, 6:, 6:], Hfa,
                              Hfa.transpose(-1, -2)]))

    # W blocks (pose x point) as flat-index scatters into (P*L, 18)
    wb_f = torch.einsum("nij,nik->njk", JfW, Jp).reshape(-1, 18)
    wb_a = torch.einsum("nij,nik->njk", JaW, Jp).reshape(-1, 18)
    Wcp = torch.zeros((P * L, 18), dtype=torch.float32, device=dev)
    Wcp.index_add_(0, torch.cat([c * L + pidx, a * L + pidx]),
                   torch.cat([wb_f, wb_a]))
    Wcp = Wcp.reshape(P, L, 6, 3)

    # H_pp (L, 3, 3)
    Hpp = torch.zeros((L, 3, 3), dtype=torch.float32, device=dev)
    Hpp.index_add_(0, pidx, torch.einsum("nij,nik->njk", JpW, Jp))

    # gradients
    g_c = torch.zeros((P, 6), dtype=torch.float32, device=dev)
    g_c.index_add_(0, torch.cat([c, a]),
                   torch.cat([torch.einsum("nij,ni->nj", JfW, r),
                              torch.einsum("nij,ni->nj", JaW, r)]))
    g_p = torch.zeros((L, 3), dtype=torch.float32, device=dev)
    g_p.index_add_(0, pidx, torch.einsum("nij,ni->nj", JpW, r))
    if not edges:
        return Hcc.reshape(P, P, 6, 6), Wcp, Hpp, g_c, g_p

    # --- pose-graph edges
    d, emask = _edge_residuals(prob, R, t)
    A = ad_se3(d)
    eye6 = torch.eye(6, dtype=d.dtype, device=dev).expand(A.shape)
    AA = A @ A
    Jr_inv = eye6 + 0.5 * A + (1.0 / 12.0) * AA
    Jl_inv = eye6 - 0.5 * A + (1.0 / 12.0) * AA
    # Adj of the constraint T_ij
    tR = hat(prob.edge_t) @ prob.edge_R
    zeros33 = torch.zeros_like(prob.edge_R)
    Adj_ij = torch.cat(
        [torch.cat([prob.edge_R, tR], dim=-1),
         torch.cat([zeros33, prob.edge_R], dim=-1)],
        dim=-2,
    )
    Ji = Jl_inv @ Adj_ij  # d err / d xi_i
    Jj = -Jr_inv  # d err / d xi_j
    # edge error convention: err = d, minimize d^T Info d; H += J^T Info J,
    # g += -J^T Info d
    W_e = prob.edge_info * emask[:, None, None]
    JiW = torch.einsum("nji,njk->nik", Ji, W_e)  # Ji^T W
    JjW = torch.einsum("nji,njk->nik", Jj, W_e)
    i, j = prob.edge_i.long(), prob.edge_j.long()
    Hij = JiW @ Jj
    Hcc.index_add_(0, torch.cat([i * P + i, j * P + j, i * P + j, j * P + i]),
                   torch.cat([JiW @ Ji, JjW @ Jj, Hij, Hij.transpose(-1, -2)]))
    g_c.index_add_(0, torch.cat([i, j]),
                   torch.cat([-torch.einsum("nij,nj->ni", JiW, d),
                              -torch.einsum("nij,nj->ni", JjW, d)]))
    return Hcc.reshape(P, P, 6, 6), Wcp, Hpp, g_c, g_p


def _inv3x3(M):
    """Batched closed-form 3x3 inverse with regularization."""
    M = M + 1e-8 * torch.eye(3, dtype=M.dtype, device=M.device)
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), (b * f - c * e)], -1),
            torch.stack([B, (a * i - c * g), -(a * f - c * d)], -1),
            torch.stack([C, -(a * h - b * g), (a * e - b * d)], -1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def _linearize(cam_params, prob, R, t, psi, lam, free, huber, anchor_perm,
               disp_info, shards=None):
    """Normal equations at (R, t, psi), damped and masked: fixed/invalid
    poses get zero rows and columns (their identity diagonal comes in
    `_schur`). Returns (Hcc, Wcp, Hpp^-1, g_c, g_p)."""
    Hcc, Wcp, Hpp, g_c, g_p = _build_normal_equations(
        cam_params, prob, R, t, psi, huber, shards, anchor_perm, disp_info)
    Hpp_inv = _inv3x3(Hpp + lam * torch.eye(3, dtype=Hpp.dtype,
                                            device=Hpp.device)[None])
    free_m = free[:, None] * free[None, :]
    return (Hcc * free_m[:, :, None, None], Wcp * free[:, None, None, None],
            Hpp_inv, g_c * free[:, None], g_p)


def _schur(Hcc, Wcp, Hpp_inv, g_c, g_p, lam, free):
    """S = Hcc + lam I - W Hpp^-1 W^T and rhs = g_c - W Hpp^-1 g_p, with a
    pure identity row for every invalid/fixed slot."""
    P, L = Wcp.shape[:2]
    Wp = torch.einsum("plik,lkj->plij", Wcp, Hpp_inv)  # (P, L, 6, 3)
    A_mat = Wp.permute(0, 2, 1, 3).reshape(P * 6, L * 3)
    B_mat = Wcp.permute(0, 2, 1, 3).reshape(P * 6, L * 3)
    S = Hcc.permute(0, 2, 1, 3).reshape(P * 6, P * 6) - A_mat @ B_mat.T
    rhs = g_c.reshape(-1) - A_mat @ g_p.reshape(-1)
    S = S + torch.diag(lam + (1.0 - free)[:, None].expand(P, 6).reshape(-1))
    return S, rhs


def _factor_solve(S, rhs, Wcp, Hpp_inv, g_p, free, point_valid):
    """Cholesky of S for the pose step dc, back-substitution for the point
    step dp = Hpp^-1 (g_p - W^T dc); non-finite steps become 0."""
    P = Wcp.shape[0]
    # a failed factorization is NaN in the twin (cho_factor), hence 0 after
    # its guard; cholesky_ex reports it in `info` instead
    Lc, info = torch.linalg.cholesky_ex(S)
    dc = torch.cholesky_solve(rhs[:, None], Lc)[:, 0]
    dc = torch.where(torch.isfinite(dc) & (info == 0), dc, 0.0)
    dc = dc.reshape(P, 6) * free[:, None]
    WTdc = torch.einsum("plij,pi->lj", Wcp, dc)
    dp = _mv(Hpp_inv, g_p - WTdc)
    dp = torch.where(torch.isfinite(dp), dp, 0.0) * point_valid[:, None]
    return dc, dp


def _lm_round(cam_params, prob, R, t, psi, lam, chi2, free, huber,
              anchor_perm, disp_info, shards=None):
    """One LM round: linearize, Schur-reduce, factor, back-substitute, and
    accept the step if chi2 drops."""
    Hcc, Wcp, Hpp_inv, g_c, g_p = _linearize(
        cam_params, prob, R, t, psi, lam, free, huber, anchor_perm, disp_info,
        shards)
    S, rhs = _schur(Hcc, Wcp, Hpp_inv, g_c, g_p, lam, free)
    dc, dp = _factor_solve(S, rhs, Wcp, Hpp_inv, g_p, free, prob.point_valid)
    # apply: left-mult pose update, additive psi update
    Te = SE3.exp(dc)
    R_new, t_new = Te.R @ R, _mv(Te.R, t) + Te.t
    psi_new = psi + dp
    chi2_new = _chi2(cam_params, prob, R_new, t_new, psi_new, huber, shards,
                     disp_info)
    accept = chi2_new < chi2
    return (torch.where(accept, R_new, R), torch.where(accept, t_new, t),
            torch.where(accept, psi_new, psi),
            torch.where(accept, lam * 0.5, lam * 4.0),
            torch.where(accept, chi2_new, chi2))


def solve_ba(
    cam_params,  # (focal, ppx, ppy, baseline) — level-0 camera
    prob: BAProblem,
    iters: int = 2,
    huber: float = 3.0,
    lambda0: float = 50.0,
    sp_axis=None,  # parallel.mesh.MeshAxis: shard the observation axis
    anchor_perm=None,
    disp_info=None,  # (O,) third-component info; None = stereo 0.333^2
):
    """LM with `iters` accepted-or-rejected rounds (g2o parity: 2 iterations,
    Huber 3, lambda0 = 50). Returns (R, t, psi, BAStats), all on the
    problem's device (with `sp_axis`: on the axis's first device), with no
    host sync."""
    shards = None
    if sp_axis is not None:
        shards = _ObsShards(prob, sp_axis, disp_info)
        prob = BAProblem(*(x.to(shards.devices[0]) for x in prob))
    R, t, psi = prob.R, prob.t, prob.psi
    # a device fill, not a host copy: torch.tensor(x, device=cuda) syncs
    lam = torch.full((), lambda0, dtype=torch.float32, device=R.device)
    chi2_0 = _chi2(cam_params, prob, R, t, psi, huber, shards, disp_info)
    free = (prob.pose_valid & ~prob.pose_fixed).to(torch.float32)
    chi2 = chi2_0
    for _ in range(iters):
        R, t, psi, lam, chi2 = _lm_round(cam_params, prob, R, t, psi, lam,
                                         chi2, free, huber, anchor_perm,
                                         disp_info, shards)
    stats = BAStats(
        chi2_0, chi2, torch.sum(prob.obs_valid.to(torch.int32)),
        torch.sum(prob.edge_valid.to(torch.int32)),
    )
    return R, t, psi, stats

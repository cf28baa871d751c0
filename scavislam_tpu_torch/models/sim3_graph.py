"""Sim3 pose-graph optimization: scale-drift-aware loop closure for the mono
mode (port of scavislam_tpu.models.sim3_graph).

A 7-dof LM over similarity transforms (Strasdat et al., "Scale Drift-Aware
Large Scale Monocular SLAM", RSS 2010; the reference's MONO-gated Sim3 g2o
types, anchored_points.h:180-218). Per edge the residual is
r = log(S_meas^-1 * S_i * S_j^-1) in the [ups, omega, sigma] tangent; the
local Jacobians of the 14 edge dofs come from forward-mode AD around zero
(dual tensors, ``torch.autograd.forward_ad``: the edges repeated once per
basis direction, all in one pass; every scale stays a 1-D tensor, so no
0-dim tangent can promote to f64), the normal equations are assembled by
scatter-add, and the dense gauge-projected system (SPD) is
solved by ``cholesky_ex`` + ``cholesky_solve``: no host read inside the
loop. A failed factorization
gives a non-finite step, which the caller sees as NaN, as the twin's
``linalg.solve`` gives it. The chi2 history is read once at the end.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

from scavislam_tpu_torch.core.lie import Sim3


def _edge_residual(eps_i, eps_j, Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    """r = log(S_m^-1 * (exp(eps_i) S_i) * (exp(eps_j) S_j)^-1), (E, 7)."""
    Si = Sim3.exp(eps_i) @ Sim3(Ri, ti, si)
    Sj = Sim3.exp(eps_j) @ Sim3(Rj, tj, sj)
    Sm = Sim3(Rm, tm, sm)
    return (Sm.inverse() @ Si @ Sj.inverse()).log()


def _edge_jacobians(args, E, dtype, device):
    """(r (E, 7), Ji (E, 7, 7), Jj (E, 7, 7)): the residual at eps = 0 and
    its derivatives by each edge end's 7 local dofs, by forward-mode AD in
    one pass: the E edges repeated 14 times, copy k carrying the k-th basis
    direction of (eps_i, eps_j) as its dual tangent."""
    reps = [x.repeat(14, *([1] * (x.dim() - 1))) for x in args]
    basis = torch.eye(14, dtype=dtype, device=device).repeat_interleave(E, 0)
    with fwAD.dual_level():
        eps = fwAD.make_dual(
            torch.zeros((14 * E, 14), dtype=dtype, device=device), basis)
        primal, tangent = fwAD.unpack_dual(
            _edge_residual(eps[:, :7], eps[:, 7:], *reps))
    J = tangent.reshape(14, E, 7).permute(1, 2, 0)  # (E, 7, 14)
    return primal[:E], J[..., :7], J[..., 7:]


def _gn_step(R, t, s, ei, ej, Rm, tm, sm, e_valid, fixed_mask, lam,
             n_nodes: int):
    """One Levenberg-Marquardt normal-equation step. Returns (delta (N, 7),
    chi2) with delta the local updates (applied left-multiplicatively)."""
    E = ei.shape[0]
    ei, ej = ei.long(), ej.long()
    args = (R[ei], t[ei], s[ei], R[ej], t[ej], s[ej], Rm, tm, sm)
    r, Ji, Jj = _edge_jacobians(args, E, R.dtype, R.device)
    w = e_valid.to(R.dtype)
    chi2 = torch.sum(w * torch.sum(r * r, dim=-1))

    # assemble H (N*7, N*7), b (N*7) by scatter-add of the edge blocks
    Hii = torch.einsum("eki,ekj,e->eij", Ji, Ji, w)
    Hjj = torch.einsum("eki,ekj,e->eij", Jj, Jj, w)
    Hij = torch.einsum("eki,ekj,e->eij", Ji, Jj, w)
    bi = torch.einsum("eki,ek,e->ei", Ji, r, w)
    bj = torch.einsum("eki,ek,e->ei", Jj, r, w)
    n = n_nodes
    H = torch.zeros((n * n, 7, 7), dtype=R.dtype, device=R.device)
    H.index_add_(0, torch.cat([ei * n + ei, ej * n + ej, ei * n + ej,
                               ej * n + ei]),
                 torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)]))
    b = torch.zeros((n, 7), dtype=R.dtype, device=R.device)
    b.index_add_(0, torch.cat([ei, ej]), torch.cat([bi, bj]))

    # gauge fixing by projection: the fixed nodes' rows and columns zeroed
    # with 1 on their diagonal, so their delta solves to exactly 0 (a huge
    # diagonal, the g2o trick, swamps the ~1-scale blocks in f32)
    free = 1.0 - fixed_mask.to(R.dtype)
    fdof = free.repeat_interleave(7)
    Hf = H.reshape(n, n, 7, 7).permute(0, 2, 1, 3).reshape(n * 7, n * 7)
    Hf = Hf * fdof[:, None] * fdof[None, :]
    Hf = Hf + torch.diag(lam * fdof + (1.0 - fdof))
    bf = b.reshape(-1) * fdof
    L, info = torch.linalg.cholesky_ex(Hf)
    delta = torch.cholesky_solve(-bf[:, None], L)[:, 0]
    # a failed factorization is a NaN step, as the twin's solve gives it
    delta = torch.where(info == 0, delta, float("nan"))
    return delta.reshape(n, 7), chi2


def _apply(R, t, s, delta):
    comp = Sim3.exp(delta) @ Sim3(R, t, s)
    return comp.R, comp.t, comp.s


def optimize_sim3_pose_graph(
    nodes: Sim3,  # batched (N, ...) node-from-world poses
    edge_i, edge_j,  # (E,) int node indices
    edge_meas: Sim3,  # (E, ...) measured S_i_from_j
    edge_valid,  # (E,) bool
    fixed_mask=None,  # (N,) bool, default: node 0
    iters: int = 10,
    lam: float = 1e-4,
):
    """LM on the Sim3 pose graph, on the nodes' device. Returns (nodes,
    chi2 history as a list of floats, one read after the last step)."""
    R, t, s = nodes.R, nodes.t, nodes.s
    n = R.shape[0]
    dev = R.device
    if fixed_mask is None:
        fixed_mask = torch.zeros(n, dtype=torch.bool, device=dev)
        fixed_mask[0] = True
    fixed_mask = torch.as_tensor(fixed_mask, dtype=torch.bool, device=dev)
    ei = torch.as_tensor(edge_i, device=dev).to(torch.int64)
    ej = torch.as_tensor(edge_j, device=dev).to(torch.int64)
    ev = torch.as_tensor(edge_valid, device=dev).to(torch.bool)
    history = []
    for _ in range(iters):
        delta, chi2 = _gn_step(R, t, s, ei, ej, edge_meas.R, edge_meas.t,
                               edge_meas.s, ev, fixed_mask, lam, n)
        R, t, s = _apply(R, t, s, delta)
        history.append(chi2)
    hist = torch.stack(history).cpu().tolist() if history else []
    return Sim3(R, t, s), hist

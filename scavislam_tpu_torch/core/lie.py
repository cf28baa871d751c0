"""SO3 / SE3 Lie groups on PyTorch tensors (port of scavislam_tpu.core.lie).

Conventions (Sophus-compatible, as in the JAX twin):
- tangent vectors are 6-vectors ``[upsilon(3), omega(3)]`` — translation first;
- a group element is a rotation matrix ``R`` (..., 3, 3) plus translation
  ``t`` (..., 3);
- retraction is LEFT-multiplicative: ``T <- exp(delta) * T``.

Everything is shape-polymorphic over leading batch dims. Near ``theta -> 0``
the f32 Taylor branches cover a WIDE neighbourhood (theta^2 < 0.04): in f32,
1 - cos(theta) cancels catastrophically up to theta ~ 0.1. Both branches of
every ``torch.where`` are finite at zero (the exact branch is computed from a
clamped angle), so forward- and reverse-mode derivatives stay finite there.

``Sim3`` is the similarity group of the monocular mode, tangent
``[upsilon(3), omega(3), sigma(1)]`` with scale ``s = exp(sigma)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_TAYLOR_T2 = 0.04


def _where_taylor(theta2, exact, taylor):
    return torch.where(theta2 < _TAYLOR_T2, taylor, exact)


def hat(omega: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    o0, o1, o2 = omega[..., 0], omega[..., 1], omega[..., 2]
    z = torch.zeros_like(o0)
    return torch.stack(
        [
            torch.stack([z, -o2, o1], dim=-1),
            torch.stack([o2, z, -o0], dim=-1),
            torch.stack([-o1, o0, z], dim=-1),
        ],
        dim=-2,
    )


def vee(Omega: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`: (..., 3, 3) -> (..., 3)."""
    return torch.stack(
        [Omega[..., 2, 1], Omega[..., 0, 2], Omega[..., 1, 0]], dim=-1
    )


def _so3_exp_coeffs(theta2):
    """Return (A, B, C) with R = I + A·Ω + B·Ω², V = I + B·Ω + C·Ω²."""
    t2s = torch.clamp(theta2, min=_TAYLOR_T2)  # safe for the exact branch
    theta = torch.sqrt(t2s)
    t4 = theta2 * theta2
    A = _where_taylor(
        theta2, torch.sin(theta) / theta,
        1.0 - theta2 / 6.0 + t4 / 120.0,
    )
    B = _where_taylor(
        theta2, (1.0 - torch.cos(theta)) / t2s,
        0.5 - theta2 / 24.0 + t4 / 720.0,
    )
    A_exact_for_C = torch.sin(theta) / theta
    C = _where_taylor(
        theta2, (1.0 - A_exact_for_C) / t2s,
        1.0 / 6.0 - theta2 / 120.0 + t4 / 5040.0,
    )
    return A, B, C


def _mv(M, x):
    """Batched matrix-vector product (..., 3, 3) x (..., 3) -> (..., 3)."""
    return (M @ x[..., None])[..., 0]


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _identity_R(batch_shape, dtype, device) -> torch.Tensor:
    return torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3)


class SO3(NamedTuple):
    """Rotation group element; `R` is (..., 3, 3)."""

    R: torch.Tensor

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device=None) -> "SO3":
        return SO3(_identity_R(batch_shape, dtype, device))

    @staticmethod
    def exp(omega: torch.Tensor) -> "SO3":
        theta2 = torch.sum(omega * omega, dim=-1)
        A, B, _ = _so3_exp_coeffs(theta2)
        Om = hat(omega)
        Om2 = Om @ Om
        R = _eye3(omega) + A[..., None, None] * Om + B[..., None, None] * Om2
        return SO3(R)

    def log(self) -> torch.Tensor:
        R = self.R
        trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
        cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
        w = vee(R - R.transpose(-1, -2)) * 0.5  # = sin(theta) * axis
        s2 = torch.sum(w * w, dim=-1)  # sin(theta)^2
        sin_theta = torch.sqrt(s2 + 1e-24)
        theta = torch.atan2(sin_theta, cos_theta)
        small = s2 < 1e-6
        scale = torch.where(
            small,
            1.0 + s2 / 6.0,
            theta / torch.where(small, torch.ones_like(sin_theta), sin_theta),
        )
        omega = w * scale[..., None]
        # near theta == pi: recover the axis from the symmetric part
        near_pi = theta > 3.0
        diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
        one_m_cos = 1.0 - cos_theta[..., None]
        axis_sq = torch.clamp(
            (diag - cos_theta[..., None]) / torch.where(
                torch.abs(one_m_cos) < 1e-12, torch.ones_like(one_m_cos),
                one_m_cos),
            min=0.0,
        )
        axis_abs = torch.sqrt(axis_sq)
        # signs from the off-diagonal symmetric entries, the largest
        # component taken positive (the twin's lax.switch, vectorized)
        k = torch.argmax(axis_abs, dim=-1)
        sym = 0.5 * (R + R.transpose(-1, -2))
        s01 = torch.sign(sym[..., 0, 1])
        s02 = torch.sign(sym[..., 0, 2])
        s12 = torch.sign(sym[..., 1, 2])
        a0, a1, a2 = axis_abs[..., 0], axis_abs[..., 1], axis_abs[..., 2]
        from0 = torch.stack([a0, s01 * a1, s02 * a2], dim=-1)
        from1 = torch.stack([s01 * a0, a1, s12 * a2], dim=-1)
        from2 = torch.stack([s02 * a0, s12 * a1, a2], dim=-1)
        kk = k[..., None]
        axis_pi = torch.where(kk == 0, from0, torch.where(kk == 1, from1, from2))
        omega_pi = axis_pi * theta[..., None]
        return torch.where(near_pi[..., None], omega_pi, omega)

    def __matmul__(self, other):
        if isinstance(other, SO3):
            return SO3(self.R @ other.R)
        return _mv(self.R, other)

    def inverse(self) -> "SO3":
        return SO3(self.R.transpose(-1, -2))


class SE3(NamedTuple):
    """Rigid transform; `R` is (..., 3, 3), `t` is (..., 3)."""

    R: torch.Tensor
    t: torch.Tensor

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device=None) -> "SE3":
        return SE3(_identity_R(batch_shape, dtype, device),
                   torch.zeros((*batch_shape, 3), dtype=dtype, device=device))

    @staticmethod
    def from_matrix(T: torch.Tensor) -> "SE3":
        return SE3(T[..., :3, :3], T[..., :3, 3])

    @staticmethod
    def exp(xi: torch.Tensor) -> "SE3":
        """Tangent [upsilon, omega] -> group element."""
        ups, omega = xi[..., :3], xi[..., 3:]
        theta2 = torch.sum(omega * omega, dim=-1)
        A, B, C = _so3_exp_coeffs(theta2)
        Om = hat(omega)
        Om2 = Om @ Om
        eye = _eye3(xi)
        R = eye + A[..., None, None] * Om + B[..., None, None] * Om2
        V = eye + B[..., None, None] * Om + C[..., None, None] * Om2
        return SE3(R, _mv(V, ups))

    def log(self) -> torch.Tensor:
        omega = SO3(self.R).log()
        theta2 = torch.sum(omega * omega, dim=-1)
        Om = hat(omega)
        Om2 = Om @ Om
        # V^{-1} = I - 1/2 Ω + (1/theta2)(1 - A/(2B)) Ω²
        A, B, _ = _so3_exp_coeffs(theta2)
        B_safe = torch.clamp(B, min=1e-6)
        coef = _where_taylor(
            theta2,
            (1.0 - A / (2.0 * B_safe)) / torch.clamp(theta2, min=_TAYLOR_T2),
            1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0,
        )
        Vinv = _eye3(self.R) - 0.5 * Om + coef[..., None, None] * Om2
        return torch.cat([_mv(Vinv, self.t), omega], dim=-1)

    def __matmul__(self, other):
        if isinstance(other, SE3):
            return SE3(self.R @ other.R, _mv(self.R, other.t) + self.t)
        return self.apply(other)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Transform points x (..., 3)."""
        return _mv(self.R, x) + self.t

    def inverse(self) -> "SE3":
        Rt = self.R.transpose(-1, -2)
        return SE3(Rt, -_mv(Rt, self.t))

    def matrix(self) -> torch.Tensor:
        """(..., 4, 4) homogeneous matrix."""
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=self.R.dtype,
                              device=self.R.device)
        bottom = bottom.expand(*self.t.shape[:-1], 1, 4)
        top = torch.cat([self.R, self.t[..., :, None]], dim=-1)
        return torch.cat([top, bottom], dim=-2)

    def adjoint(self) -> torch.Tensor:
        """(..., 6, 6) adjoint: Ad(T) @ xi = (T * exp(xi) * T^-1).log()."""
        top = torch.cat([self.R, hat(self.t) @ self.R], dim=-1)
        bot = torch.cat([torch.zeros_like(self.R), self.R], dim=-1)
        return torch.cat([top, bot], dim=-2)

    def retract(self, delta: torch.Tensor) -> "SE3":
        """Left-multiplicative update exp(delta) * self."""
        return SE3.exp(delta) @ self

    @staticmethod
    def stack(transforms) -> "SE3":
        return SE3(torch.stack([T.R for T in transforms]),
                   torch.stack([T.t for T in transforms]))

    def slice(self, idx) -> "SE3":
        return SE3(self.R[idx], self.t[idx])


def lie_bracket_se3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """se(3) Lie bracket [a, b] for 6-vectors [ups, omega]."""
    au, aw = a[..., :3], a[..., 3:]
    bu, bw = b[..., :3], b[..., 3:]
    return torch.cat(
        [torch.linalg.cross(aw, bu) + torch.linalg.cross(au, bw),
         torch.linalg.cross(aw, bw)], dim=-1)


def ad_se3(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6, 6) adjoint of a tangent vector: ad(xi) @ y = [xi, y]."""
    ups, omega = xi[..., :3], xi[..., 3:]
    Ou, Ow = hat(ups), hat(omega)
    top = torch.cat([Ow, Ou], dim=-1)
    bot = torch.cat([torch.zeros_like(Ow), Ow], dim=-1)
    return torch.cat([top, bot], dim=-2)


class Sim3(NamedTuple):
    """Similarity transform (s * R, t), the monocular mode's pose type.
    Tangent layout [upsilon(3), omega(3), sigma(1)] with s = exp(sigma)."""

    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)
    s: torch.Tensor  # (...,) scale

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device=None) -> "Sim3":
        return Sim3(_identity_R(batch_shape, dtype, device),
                    torch.zeros((*batch_shape, 3), dtype=dtype, device=device),
                    torch.ones(batch_shape, dtype=dtype, device=device))

    @staticmethod
    def exp(xi: torch.Tensor) -> "Sim3":
        """7-vector [ups, omega, sigma] -> group element, t = W ups with
        W = A I + B Om + C Om^2 (Strasdat's closed form); each series branch
        is selected by a where over a denominator kept away from zero."""
        ups, omega, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
        R = SO3.exp(omega).R
        s = torch.exp(sigma)
        theta2 = torch.sum(omega * omega, dim=-1)
        theta = torch.sqrt(torch.clamp(theta2, min=1e-12))
        Om = hat(omega)
        Om2 = Om @ Om
        one = torch.ones_like(sigma)

        sig_small = torch.abs(sigma) < 1e-4
        th_small = theta2 < 1e-6
        sig_safe = torch.where(sig_small, one, sigma)
        th_safe = torch.where(th_small, one, theta)

        A_ss = 1.0 + sigma / 2.0 + sigma * sigma / 6.0  # (e^s - 1)/s series
        A = torch.where(sig_small, A_ss, (s - 1.0) / sig_safe)

        a = s * torch.sin(th_safe)
        b = s * torch.cos(th_safe)
        c = theta2 + sigma * sigma
        c_safe = torch.where(c < 1e-12, one, c)
        B_gen = (a * sigma + (1.0 - b) * theta) / (th_safe * c_safe)
        C_gen = (A - ((b - 1.0) * sigma + a * theta) / c_safe) / torch.clamp(
            theta2, min=1e-12)
        B = torch.where(th_small, 0.5 - sigma / 6.0, B_gen)  # theta -> 0
        C = torch.where(th_small, 1.0 / 6.0 - sigma / 24.0, C_gen)

        W = (A[..., None, None] * _eye3(xi) + B[..., None, None] * Om
             + C[..., None, None] * Om2)
        return Sim3(R, _mv(W, ups), s)

    def log(self) -> torch.Tensor:
        """Group element -> 7-vector; W is rebuilt column by column from
        exp at unit translations and inverted in closed form (`_solve3`:
        elementwise, so the Sim3 pose graph's forward-mode Jacobians go
        through no library solve)."""
        omega = SO3(self.R).log()
        sigma = torch.log(self.s)
        eye = _eye3(self.t)
        cols = []
        for i in range(3):
            probe = torch.cat([eye[i].expand(omega.shape), omega,
                               sigma[..., None]], dim=-1)
            cols.append(Sim3.exp(probe).t)
        W = torch.stack(cols, dim=-1)
        return torch.cat([_solve3(W, self.t), omega, sigma[..., None]],
                         dim=-1)

    def __matmul__(self, other):
        if isinstance(other, Sim3):
            return Sim3(self.R @ other.R,
                        self.s[..., None] * _mv(self.R, other.t) + self.t,
                        self.s * other.s)
        return self.apply(other)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.s[..., None] * _mv(self.R, x) + self.t

    def inverse(self) -> "Sim3":
        Rt = self.R.transpose(-1, -2)
        s_inv = 1.0 / self.s
        return Sim3(Rt, -s_inv[..., None] * _mv(Rt, self.t), s_inv)


def _solve3(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M^-1 v for (..., 3, 3) M by the adjugate: the inverse's columns are
    the cross products of M's rows over det M."""
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c0 = torch.linalg.cross(r1, r2)
    c1 = torch.linalg.cross(r2, r0)
    c2 = torch.linalg.cross(r0, r1)
    det = torch.sum(r0 * c0, dim=-1)
    x = c0 * v[..., 0:1] + c1 * v[..., 1:2] + c2 * v[..., 2:3]
    return x / det[..., None]


def se3_exp_host(xi: np.ndarray):
    """SE3.exp of ONE tangent vector on the host, in numpy float32: the same
    formula and Taylor branches, without a device round trip. Used by the LM
    loops, which update a single pose per iteration. Returns (R, t)."""
    f32 = np.float32
    xi = np.asarray(xi, f32)
    ups, omega = xi[:3], xi[3:]
    theta2 = f32(np.sum(omega * omega))
    if theta2 < _TAYLOR_T2:
        t4 = theta2 * theta2
        A = f32(1.0) - theta2 / f32(6.0) + t4 / f32(120.0)
        B = f32(0.5) - theta2 / f32(24.0) + t4 / f32(720.0)
        C = f32(1.0 / 6.0) - theta2 / f32(120.0) + t4 / f32(5040.0)
    else:
        theta = np.sqrt(theta2)
        A = np.sin(theta) / theta
        B = (f32(1.0) - np.cos(theta)) / theta2
        C = (f32(1.0) - A) / theta2
    o0, o1, o2 = omega
    z = f32(0.0)
    Om = np.array([[z, -o2, o1], [o2, z, -o0], [-o1, o0, z]], f32)
    Om2 = Om @ Om
    eye = np.eye(3, dtype=f32)
    R = (eye + A * Om + B * Om2).astype(f32)
    V = (eye + B * Om + C * Om2).astype(f32)
    return R, (V @ ups).astype(f32)


class PoseRT(NamedTuple):
    """Host-side numpy rigid pose (R, t): the per-frame bookkeeping type
    (trajectories, packets, keyframe policy) — it never touches the device.
    SE3 stays the device type; PoseRT is its host mirror."""

    R: np.ndarray
    t: np.ndarray

    @staticmethod
    def from_any(T) -> "PoseRT":
        if isinstance(T, PoseRT):
            return T
        if isinstance(T, tuple) and not isinstance(T, SE3):
            return PoseRT(np.asarray(T[0], np.float64),
                          np.asarray(T[1], np.float64))
        return PoseRT(_to_np64(T.R), _to_np64(T.t))

    def __matmul__(self, other) -> "PoseRT":
        o = PoseRT.from_any(other)
        return PoseRT(self.R @ o.R, self.R @ o.t + self.t)

    def inverse(self) -> "PoseRT":
        Rt = np.ascontiguousarray(self.R.T)
        return PoseRT(Rt, -(Rt @ self.t))

    def as_se3(self, device=None) -> SE3:
        return SE3(torch.as_tensor(np.asarray(self.R, np.float32), device=device),
                   torch.as_tensor(np.asarray(self.t, np.float32), device=device))

    def log(self):
        return self.as_se3().log()


def _to_np64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def umeyama_sim3(A: np.ndarray, B: np.ndarray, with_scale: bool = True):
    """Closed-form least-squares similarity with B ~ s R A + t over all rows
    (Umeyama 1991), in host numpy. Returns (s, R, t)."""
    mu_a, mu_b = A.mean(0), B.mean(0)
    Ac, Bc = A - mu_a, B - mu_b
    C = Bc.T @ Ac / len(A)
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_a = (Ac ** 2).sum() / len(A)
    s = (float(np.trace(np.diag(D) @ S) / max(var_a, 1e-12))
         if with_scale else 1.0)
    t = mu_b - s * R @ mu_a
    return s, R.astype(np.float32), t.astype(np.float32)

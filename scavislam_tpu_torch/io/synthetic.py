"""Synthetic stereo sequences with exact ground truth, rendered with PyTorch
on a given device (port of the parts of scavislam_tpu.io.synthetic the
stereo-VO slice uses).

Scene model: textured planes. Each pixel's ray is cast against every plane,
the nearest positive hit wins, and a multi-octave value-noise texture is
evaluated at the hit point. Left/right images come from the two rectified
viewpoints, so stereo geometry and photometric constancy are exact.

The texture's lattice hash is ``fract(sin(x) * 43758.5453)``: it amplifies
a one-ulp difference in sin() ~4e4-fold, so renders agree with the JAX
renderer to f32 rounding in their geometry (depth, disparity) but only
statistically in their texture, wherever two libraries' f32 sin differ in
the last bit.

Not ported yet: ``Degradation`` and free-standing boxes and spheres.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from scavislam_tpu_torch import resolve_device
from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.core.lie import SE3


class Plane(NamedTuple):
    normal: tuple  # (3,) unit, world frame
    offset: float  # points x with n.x = offset
    tex_u: tuple  # (3,) texture axis 1
    tex_v: tuple  # (3,) texture axis 2
    tex_phase: float  # decorrelates textures across planes


def default_room() -> list[Plane]:
    """Back wall at z=6, floor at y=1.5, right wall at x=4."""
    return [
        Plane((0.0, 0.0, 1.0), 6.0, (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), 0.0),
        Plane((0.0, 1.0, 0.0), 1.5, (1.0, 0.0, 0.0), (0.0, 0.0, 1.0), 11.0),
        Plane((1.0, 0.0, 0.0), 4.0, (0.0, 0.0, 1.0), (0.0, 1.0, 0.0), 23.0),
    ]


def closed_box() -> list[Plane]:
    """A fully closed textured box around the origin (every viewing
    direction hits scenery)."""
    return [
        Plane((0, 0, 1), 6.0, (1, 0, 0), (0, 1, 0), 0.0),    # front wall
        Plane((0, 0, -1), 6.0, (1, 0, 0), (0, 1, 0), 7.0),   # back wall
        Plane((1, 0, 0), 5.0, (0, 0, 1), (0, 1, 0), 23.0),   # right wall
        Plane((-1, 0, 0), 5.0, (0, 0, 1), (0, 1, 0), 31.0),  # left wall
        Plane((0, 1, 0), 1.8, (1, 0, 0), (0, 0, 1), 11.0),   # floor
        Plane((0, -1, 0), 1.8, (1, 0, 0), (0, 0, 1), 17.0),  # ceiling
    ]


def varied_box(seed: int) -> list[Plane]:
    """:func:`closed_box` with per-plane texture phases drawn from `seed`
    (``np.random.RandomState(seed).uniform(0, 100)``, as f32): a distinct
    scene appearance per seed, the same geometry."""
    rng = np.random.RandomState(seed)
    return [p._replace(tex_phase=float(np.float32(rng.uniform(0, 100))))
            for p in closed_box()]


def _hash_lattice(ix, iy, phase):
    """Pseudo-random value in [0,1) at integer lattice points (sin hash)."""
    ph = float(np.float32(phase) * np.float32(37.719))  # an f32 product
    h = torch.sin(ix * 12.9898 + iy * 78.233 + ph) * 43758.5453
    return h - torch.floor(h)


def _value_noise(u, v, phase):
    """Smoothly interpolated lattice noise."""
    iu = torch.floor(u)
    iv = torch.floor(v)
    fu = u - iu
    fv = v - iv
    wu = fu * fu * (3.0 - 2.0 * fu)
    wv = fv * fv * (3.0 - 2.0 * fv)
    n00 = _hash_lattice(iu, iv, phase)
    n01 = _hash_lattice(iu + 1.0, iv, phase)
    n10 = _hash_lattice(iu, iv + 1.0, phase)
    n11 = _hash_lattice(iu + 1.0, iv + 1.0, phase)
    return ((n00 * (1 - wu) + n01 * wu) * (1 - wv)
            + (n10 * (1 - wu) + n11 * wu) * wv)


def _texture(u, v, phase):
    """Multi-octave value noise in ~[0.05, 0.95]."""
    phase = float(np.float32(phase))
    val = (
        0.45 * _value_noise(u * 0.7, v * 0.7, phase)
        + 0.30 * _value_noise(u * 1.9 + 31.0, v * 1.9,
                              float(np.float32(phase) + np.float32(1.0)))
        + 0.15 * _value_noise(u * 4.3, v * 4.3 + 17.0,
                              float(np.float32(phase) + np.float32(2.0)))
        + 0.10 * _value_noise(u * 9.1 + 5.0, v * 9.1,
                              float(np.float32(phase) + np.float32(3.0)))
    )
    return 0.08 + 0.84 * val


def _render_view(planes, T_cw: SE3, cam: StereoCamera, eye_offset: float):
    """Render one view; eye_offset is 0 (left) or the baseline (right eye)."""
    w, h = cam.size
    dev = T_cw.R.device
    f32 = torch.float32
    u = torch.arange(w, dtype=f32, device=dev)[None, :]
    v = torch.arange(h, dtype=f32, device=dev)[:, None]
    dx = (u - cam.pp[0]) / cam.focal
    dy = (v - cam.pp[1]) / cam.focal
    dirs_c = torch.stack([dx.expand(h, w), dy.expand(h, w),
                          torch.ones((h, w), dtype=f32, device=dev)], dim=-1)
    T_wc = T_cw.inverse()
    origin_c = torch.tensor([eye_offset, 0.0, 0.0], dtype=f32, device=dev)
    origin_w = T_wc.apply(origin_c)
    dirs_w = torch.einsum("ij,hwj->hwi", T_wc.R, dirs_c)

    best_t = torch.full((h, w), float("inf"), dtype=f32, device=dev)
    img = torch.zeros((h, w), dtype=f32, device=dev)
    for p in planes:
        normal = torch.tensor(p.normal, dtype=f32, device=dev)
        denom = torch.einsum("hwi,i->hw", dirs_w, normal)
        denom = torch.where(torch.abs(denom) < 1e-9,
                            torch.full_like(denom, 1e-9), denom)
        t = (p.offset - torch.dot(origin_w, normal)) / denom
        t = torch.where(t > 0.1, t, torch.full_like(t, float("inf")))
        hit = t < best_t
        t_safe = torch.where(torch.isfinite(t), t, torch.zeros_like(t))
        pt = origin_w + t_safe[..., None] * dirs_w
        tu = torch.einsum("hwi,i->hw", pt,
                          torch.tensor(p.tex_u, dtype=f32, device=dev))
        tv = torch.einsum("hwi,i->hw", pt,
                          torch.tensor(p.tex_v, dtype=f32, device=dev))
        tex = _texture(tu * 4.0, tv * 4.0, p.tex_phase)
        img = torch.where(hit, tex, img)
        best_t = torch.where(hit, t, best_t)
    # depth along camera z = t (dirs_c z == 1) in the eye frame
    return img, best_t


def render_stereo_frame(planes, T_cw: SE3, cam: StereoCamera):
    """Render (left, right, disparity, depth) for camera pose T_cw.
    Disparity is exact: d = f*b/z with z the left-eye depth."""
    left, depth = _render_view(planes, T_cw, cam, 0.0)
    right, _ = _render_view(planes, T_cw, cam, float(cam.baseline))
    fb = float(np.float32(cam.focal) * np.float32(cam.baseline))
    disp = fb / depth
    disp = torch.where(torch.isfinite(disp), disp, torch.zeros_like(disp))
    return left, right, disp, depth


def make_trajectory(n_frames: int, kind: str = "forward_arc",
                    step: float = 0.02) -> list[SE3]:
    """Ground-truth camera poses T_cw (world->camera), f32 CPU tensors."""
    poses = []
    for i in range(n_frames):
        s = i * step
        if kind == "forward_arc":
            t_wc = np.array([0.6 * np.sin(s * 1.2), -0.1 * s, 1.8 * s])
            yaw = 0.15 * np.sin(s * 2.0)
        elif kind == "orbit":
            t_wc = np.array([1.2 * np.sin(s * 2.4), 0.0,
                             1.2 * (1 - np.cos(s * 2.4))])
            yaw = -0.5 * s
        elif kind == "out_and_back":
            # drive forward, then return to the start
            total = max((n_frames - 1) * step, 1e-6)
            half = total / 2.0
            p = s / half if s <= half else max(total - s, 0.0) / half
            t_wc = np.array([0.3 * np.sin(p * 1.5), 0.0, 2.2 * p])
            yaw = 0.1 * np.sin(p * 3.0)
        elif kind == "spin":
            # in-place 360-degree yaw (with closed_box()): the revisit of the
            # initial heading is a pure appearance loop, the frames half-way
            # through share no covisibility with the start
            t_wc = np.array([0.05 * np.sin(s * 6.28), 0.0,
                             0.05 * (1 - np.cos(s * 6.28))])
            yaw = 2.0 * np.pi * s
        elif kind == "wander":
            # long non-self-revisiting Lissajous path inside a closed box,
            # starting at the origin, yaw ~0.1 deg/frame at step 0.015
            t_wc = np.array([
                3.0 * np.sin(0.7 * s),
                0.3 * np.sin(1.1 * s),
                2.0 * (np.sin(0.41 * s + 1.0) - np.sin(1.0)),
            ])
            yaw = 0.6 * np.sin(0.23 * s)
        elif kind == "still":
            t_wc = np.zeros(3)
            yaw = 0.0
        else:
            raise ValueError(kind)
        cy, sy = np.cos(yaw), np.sin(yaw)
        R_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], dtype=np.float32)
        T_wc = SE3(torch.as_tensor(R_wc),
                   torch.as_tensor(t_wc.astype(np.float32)))
        poses.append(T_wc.inverse())
    return poses


class SyntheticSequence:
    """Rendered stereo frames with ground truth: each item has left/right
    float images in [0, 1] on `device`, exact disparity, and the
    ground-truth pose T_cw (CPU tensors)."""

    def __init__(self, cam: StereoCamera, n_frames=30, kind="forward_arc",
                 planes=None, step=0.02, device=None):
        self.cam = cam
        self.planes = planes if planes is not None else default_room()
        self.poses = make_trajectory(n_frames, kind, step)
        self.device = resolve_device(device)

    def __len__(self):
        return len(self.poses)

    def frame(self, i):
        T = self.poses[i]
        T_dev = SE3(T.R.to(self.device), T.t.to(self.device))
        left, right, disp, depth = render_stereo_frame(self.planes, T_dev,
                                                       self.cam)
        return {
            "frame_id": i,
            "left": left,
            "right": right,
            "disp_gt": disp,
            "depth_gt": depth,
            "T_cw_gt": T,
        }

    def __iter__(self):
        for i in range(len(self)):
            yield self.frame(i)

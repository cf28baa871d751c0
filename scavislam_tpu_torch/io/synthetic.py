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

Besides planes, a scene may hold free-standing textured boxes and spheres
(``cluttered_room``): interior occlusion boundaries and depth
discontinuities. ``Degradation`` adds sensor and scene effects (noise,
exposure drift, vignetting, a moving occluder, motion blur) to each
rendered view. Its noise is drawn from a ``torch.Generator`` seeded from
(seed, 2 * frame + eye), so it cannot replay the twin's ``jax.random``
draws: noise agrees with the twin only statistically.
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


class Box(NamedTuple):
    """Free-standing axis-aligned textured box: its silhouette writes depth
    discontinuities inside the image, which textured planes never do."""

    lo: tuple  # (3,) min corner, world frame
    hi: tuple  # (3,) max corner
    tex_phase: float


class Sphere(NamedTuple):
    """Free-standing textured sphere: a curved occlusion boundary and
    smoothly varying depth."""

    center: tuple  # (3,)
    radius: float
    tex_phase: float


def _f32s(xs) -> tuple:
    return tuple(float(x) for x in np.asarray(xs, np.float32))


def cluttered_room(seed: int = 0, n_boxes: int = 3,
                   n_spheres: int = 2) -> list:
    """default_room() plus free-standing boxes and spheres at distinct
    depths in front of the camera, placed from `seed` inside the
    forward-arc view and clear of the camera path (z >= 1.6)."""
    rng = np.random.RandomState(seed + 101)
    prims: list = list(default_room())
    for _ in range(n_boxes):
        cx = float(rng.uniform(-1.6, 2.2))
        cy = float(rng.uniform(-0.4, 1.0))
        cz = float(rng.uniform(1.8, 4.6))
        s = rng.uniform(0.18, 0.45, size=3)
        prims.append(Box(
            _f32s([cx - s[0], cy - s[1], cz - s[2]]),
            _f32s([cx + s[0], cy + s[1], cz + s[2]]),
            float(np.float32(rng.uniform(40, 80))),
        ))
    for _ in range(n_spheres):
        cx = float(rng.uniform(-1.2, 2.0))
        cy = float(rng.uniform(-0.3, 0.9))
        cz = float(rng.uniform(1.6, 4.2))
        prims.append(Sphere(
            _f32s([cx, cy, cz]),
            float(np.float32(rng.uniform(0.18, 0.4))),
            float(np.float32(rng.uniform(40, 80))),
        ))
    return prims


# skew texture-projection axes for boxes and spheres: no face or viewing
# direction is degenerate under either projection
_TEX_A1 = (0.90, 0.45, 0.20)
_TEX_A2 = (0.20, 0.80, -0.55)


def _vec(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _intersect_box(origin_w, dirs_w, box: Box):
    """Slab-method ray/AABB: the entry t (inf on a miss)."""
    d = torch.where(torch.abs(dirs_w) < 1e-9,
                    torch.full_like(dirs_w, 1e-9), dirs_w)
    t1 = (_vec(box.lo, dirs_w) - origin_w) / d
    t2 = (_vec(box.hi, dirs_w) - origin_w) / d
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    hit = (tmax >= tmin) & (tmin > 0.1)
    return torch.where(hit, tmin, torch.full_like(tmin, float("inf")))


def _intersect_sphere(origin_w, dirs_w, sp: Sphere):
    """Nearest positive ray/sphere intersection (inf on a miss)."""
    oc = origin_w - _vec(sp.center, dirs_w)
    r = _vec(sp.radius, dirs_w)
    a = torch.sum(dirs_w * dirs_w, dim=-1)
    b = 2.0 * torch.einsum("...i,i->...", dirs_w, oc)
    c = torch.dot(oc, oc) - r * r
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = (-b - sq) / (2.0 * a)
    t1 = (-b + sq) / (2.0 * a)
    t = torch.where(t0 > 0.1, t0, t1)
    hit = (disc > 0.0) & (t > 0.1)
    return torch.where(hit, t, torch.full_like(t, float("inf")))


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


class Degradation(NamedTuple):
    """Sensor and scene degradations for robustness runs, applied to each
    rendered view:

    - ``noise_std``: additive per-pixel Gaussian (independent per eye and
      per frame), in [0, 1] intensity units (0.04 ~ 10/255);
    - ``exposure_amp`` / ``exposure_period``: global gain drift
      1 + amp * sin(2 pi i / period), which breaks photometric constancy
      between frames;
    - ``vignette``: radial intensity falloff (static per eye), which breaks
      photometric constancy under rotation;
    - ``occluder_frac``: a textured square of this fraction of the image
      width sweeping across the view at ``occluder_depth`` meters, an
      independently moving object; ground-truth disparity and depth follow
      it, the ground-truth pose does not;
    - ``motion_blur``: a 5-px horizontal box mixed in at this strength,
      applied before the noise (blur is optical, noise is readout).
    """

    noise_std: float = 0.0
    exposure_amp: float = 0.0
    exposure_period: float = 40.0
    vignette: float = 0.0
    occluder_frac: float = 0.0
    occluder_depth: float = 1.2
    motion_blur: float = 0.0
    seed: int = 0


def _apply_occluder(left, right, disp, depth, i, n_frames, deg: Degradation,
                    cam: StereoCamera):
    w, h = cam.size
    f32 = np.float32
    side = deg.occluder_frac * w
    # sweep across the view over the sequence (scalars in f32, as the twin)
    prog = f32(i) / f32(max(n_frames - 1, 1))
    cx = float((f32(0.15) + f32(0.7) * prog) * f32(w))
    cy = 0.55 * h
    d_occ = float(f32(cam.focal) * f32(cam.baseline) / f32(deg.occluder_depth))
    shift = float(prog * f32(7.0))
    u = torch.arange(w, dtype=torch.float32, device=left.device)[None, :]
    v = torch.arange(h, dtype=torch.float32, device=left.device)[:, None]
    box_l = (torch.abs(u - cx) < side / 2) & (torch.abs(v - cy) < side / 2)
    box_r = (torch.abs(u - float(f32(cx) - f32(d_occ))) < side / 2) & (
        torch.abs(v - cy) < side / 2)
    # the object carries its own texture and moves relative to the scene
    tex_l = _texture(u * 0.12 + shift, v * 0.12, 55.0)
    tex_r = _texture((u + d_occ) * 0.12 + shift, v * 0.12, 55.0)
    left = torch.where(box_l, tex_l.expand_as(left), left)
    right = torch.where(box_r, tex_r.expand_as(right), right)
    disp = torch.where(box_l, torch.full_like(disp, d_occ), disp)
    depth = torch.where(box_l, torch.full_like(depth, deg.occluder_depth),
                        depth)
    return left, right, disp, depth


def noise_generator(seed: int, i: int, eye: int, device) -> torch.Generator:
    """The generator of one view's noise, seeded from (seed, 2 * i + eye)."""
    g = torch.Generator(device=device)
    state = np.random.SeedSequence([seed, 2 * i + eye]).generate_state(
        1, np.uint64)[0]
    g.manual_seed(int(state))
    return g


def _degrade_view(img, i, eye, deg: Degradation, cam: StereoCamera):
    w, h = cam.size
    if deg.motion_blur > 0.0:
        # 5-px horizontal box mixed in at `motion_blur` strength (the
        # wrap-around columns are negligible at image widths)
        box = (img + torch.roll(img, 1, 1) + torch.roll(img, -1, 1)
               + torch.roll(img, 2, 1) + torch.roll(img, -2, 1)) / 5.0
        img = (1.0 - deg.motion_blur) * img + deg.motion_blur * box
    if deg.vignette > 0.0:
        u = (torch.arange(w, dtype=torch.float32, device=img.device)
             - cam.pp[0]) / (w / 2)
        v = (torch.arange(h, dtype=torch.float32, device=img.device)
             - cam.pp[1]) / (h / 2)
        r2 = u[None, :] ** 2 + v[:, None] ** 2
        img = img * (1.0 - 0.5 * deg.vignette * r2)
    if deg.exposure_amp > 0.0:
        phase = np.float32(2.0 * np.pi) * np.float32(i) / np.float32(
            deg.exposure_period)
        img = img * float(np.float32(1.0) + np.float32(deg.exposure_amp)
                          * np.sin(phase))
    if deg.noise_std > 0.0:
        g = noise_generator(deg.seed, i, eye, img.device)
        img = img + deg.noise_std * torch.randn(
            img.shape, generator=g, dtype=torch.float32, device=img.device)
    return torch.clamp(img, 0.0, 1.0)


def _render_view(planes, T_cw: SE3, cam: StereoCamera, eye_offset: float):
    """Render one view; eye_offset is 0 (left) or the baseline (right eye).
    `planes` may also hold Box and Sphere primitives."""
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
        if isinstance(p, Plane):
            normal = torch.tensor(p.normal, dtype=f32, device=dev)
            denom = torch.einsum("hwi,i->hw", dirs_w, normal)
            denom = torch.where(torch.abs(denom) < 1e-9,
                                torch.full_like(denom, 1e-9), denom)
            t = (p.offset - torch.dot(origin_w, normal)) / denom
            t = torch.where(t > 0.1, t, torch.full_like(t, float("inf")))
            tex_u, tex_v = p.tex_u, p.tex_v
        elif isinstance(p, Box):
            t = _intersect_box(origin_w, dirs_w, p)
            tex_u, tex_v = _TEX_A1, _TEX_A2
        else:  # Sphere
            t = _intersect_sphere(origin_w, dirs_w, p)
            tex_u, tex_v = _TEX_A1, _TEX_A2
        hit = t < best_t
        t_safe = torch.where(torch.isfinite(t), t, torch.zeros_like(t))
        pt = origin_w + t_safe[..., None] * dirs_w
        tu = torch.einsum("hwi,i->hw", pt,
                          torch.tensor(tex_u, dtype=f32, device=dev))
        tv = torch.einsum("hwi,i->hw", pt,
                          torch.tensor(tex_v, dtype=f32, device=dev))
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
    ground-truth pose T_cw (CPU tensors). `degrade` applies a
    :class:`Degradation` to every frame."""

    def __init__(self, cam: StereoCamera, n_frames=30, kind="forward_arc",
                 planes=None, step=0.02, degrade: Degradation = None,
                 device=None):
        self.cam = cam
        self.planes = planes if planes is not None else default_room()
        self.poses = make_trajectory(n_frames, kind, step)
        self.degrade = degrade
        self.device = resolve_device(device)

    def __len__(self):
        return len(self.poses)

    def frame(self, i):
        T = self.poses[i]
        T_dev = SE3(T.R.to(self.device), T.t.to(self.device))
        left, right, disp, depth = render_stereo_frame(self.planes, T_dev,
                                                       self.cam)
        d = self.degrade
        if d is not None:
            if d.occluder_frac > 0.0:
                left, right, disp, depth = _apply_occluder(
                    left, right, disp, depth, i, len(self), d, self.cam)
            left = _degrade_view(left, i, 0, d, self.cam)
            right = _degrade_view(right, i, 1, d, self.cam)
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

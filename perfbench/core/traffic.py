"""The one traffic generator: renders a traffic file's streams of stereo
frames on the device, with exact ground truth.

A traffic file (traffic/<mix>.json) holds parameters only:

- ``path``, ``step``: the camera path (``make_trajectory``'s kind) and its
  step per frame;
- ``scenes``: one scene per stream, ``"closed_box"`` or
  ``"varied_box:<k>"``; a configuration with B streams takes the first B;
- ``starts``: each stream's first frame on the path (stream s starts at
  ``starts[s % len(starts)]``);
- ``noise_std``, ``noise_seed``: additive Gaussian sensor noise per pixel,
  eye and frame (in [0, 1] intensity units, before the uint8 rounding),
  drawn from one fixed stream per traffic stream: ``noise_seed`` and the
  stream's index seed it, not ``--seed``;
- ``max_frames``: frames rendered per stream at set-up; a run that
  exhausts them ends its window there;
- ``ate_frames``: the fixed prefix that ``ate_m`` is taken over;
- ``warmup_frames``: frames stepped in set-up, before the window;
- ``check_frames`` / ``check_span``: how many frames of the window the
  reference checks, drawn from the seed among its first ``check_span``;
- ``trace_frames``: the calls of the profiled sub-window (``--trace 1``).

The frames, their noise included, are the same for every seed: the seed
picks the calls whose outputs the reference checks. (Noise or starting
frames drawn from the seed change the work and the accuracy from seed to
seed by more than a bound can hold: PERF.md.) Ground truth is in the
first frame's gauge (the system's first keyframe sits at the origin). The
program receives only the frames.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.gen import synthetic
from perfbench.gen.camera import StereoCamera
from perfbench.gen.lie import SE3

RENDER_CHUNK = 32  # frames rendered by one vmapped call


def scene(spec: str):
    if spec == "closed_box":
        return synthetic.closed_box()
    kind, _, k = spec.partition(":")
    if kind == "varied_box":
        return synthetic.varied_box(int(k))
    raise ValueError(f"unknown scene {spec!r}")


def camera(cam_cfg: dict) -> StereoCamera:
    return StereoCamera.create(cam_cfg["f"], (cam_cfg["px"], cam_cfg["py"]),
                               (cam_cfg["width"], cam_cfg["height"]),
                               cam_cfg["baseline"])


def _seed_words(seed: int, *path) -> int:
    """A 32-bit word drawn from (seed, *path): any whole seed, however
    large, maps to its own draws."""
    return int(np.random.SeedSequence([int(seed) & (2**64 - 1), *path])
               .generate_state(1, np.uint32)[0])


def check_positions(traffic: dict, seed: int) -> list:
    """Positions, counted from the window's first call, whose outputs
    the reference checks."""
    span, k = int(traffic["check_span"]), int(traffic["check_frames"])
    rng = np.random.default_rng(_seed_words(seed, 1))
    return sorted(int(x) for x in rng.choice(span, size=k, replace=False))


def ground_truth(traffic: dict, i0: int, n: int) -> list:
    """The n poses T_cw from frame i0 of the path, and the same in the
    first frame's gauge (f32 CPU SE3)."""
    poses = synthetic.make_trajectory(i0 + n, traffic["path"],
                                      traffic["step"])[i0:]
    R0 = poses[0].R.numpy().astype(np.float64)
    t0 = poses[0].t.numpy().astype(np.float64)
    out = []
    for T in poses:  # T_i @ T_0^-1
        R = T.R.numpy().astype(np.float64)
        t = T.t.numpy().astype(np.float64)
        Rg = R @ R0.T
        out.append(SE3(torch.as_tensor(Rg.astype(np.float32)),
                       torch.as_tensor((t - Rg @ t0).astype(np.float32))))
    return out, poses


def _to_u8(img):
    """[0, 1] float -> uint8, round half up."""
    return (torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def noise_generator(traffic: dict, stream: int, device) -> torch.Generator:
    """The fixed stream of stream `stream`'s sensor noise."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence(
        [int(traffic["noise_seed"]), stream]).generate_state(1, np.uint64)[0]))
    return g


def render_stream(traffic: dict, cam: StereoCamera, spec: str, i0: int,
                  n: int, device, stream: int = 0) -> tuple:
    """(stacks, gt): n uint8 (2, H, W) stacks on `device` from frame i0 of
    the path, with the sensor noise of stream `stream`, and their ground
    truth."""
    gt, poses = ground_truth(traffic, i0, n)
    std = float(traffic["noise_std"])
    g = noise_generator(traffic, stream, device)
    planes = scene(spec)

    def render(R, t):
        left, right, _, _ = synthetic.render_stereo_frame(
            planes, SE3(R, t), cam)
        return torch.stack([left, right])

    batched = torch.func.vmap(render)
    Rs = torch.stack([T.R for T in poses]).to(device)
    ts = torch.stack([T.t for T in poses]).to(device)
    h, w = cam.size[1], cam.size[0]
    stacks = torch.empty((n, 2, h, w), dtype=torch.uint8, device=device)
    for a in range(0, n, RENDER_CHUNK):
        b = min(a + RENDER_CHUNK, n)
        img = batched(Rs[a:b], ts[a:b])
        if std > 0.0:
            img = img + std * torch.randn(img.shape, generator=g,
                                          dtype=img.dtype, device=img.device)
        stacks[a:b] = _to_u8(img)
    return stacks, gt


class Traffic:
    """A traffic file rendered for one seed: ``streams[s]`` is
    (stacks, gt) for stream s."""

    def __init__(self, traffic: dict, cam_cfg: dict, n_streams: int,
                 seed: int, device):
        self.params = traffic
        self.cam = camera(cam_cfg)
        self.n = int(traffic["max_frames"])
        scenes = traffic["scenes"]
        if len(scenes) < n_streams:
            raise ValueError(f"{n_streams} streams, {len(scenes)} scenes")
        starts = traffic["starts"]
        self.streams = [render_stream(traffic, self.cam, scenes[s],
                                      int(starts[s % len(starts)]), self.n,
                                      device, s)
                        for s in range(n_streams)]
        self.check_positions = check_positions(traffic, seed)
        self.ate_frames = int(traffic["ate_frames"])
        self.warmup_frames = int(traffic["warmup_frames"])
        self.trace_frames = int(traffic["trace_frames"])

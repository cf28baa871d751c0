"""Cases and references for the dense tracker's inverse-compositional
evaluation (``ops/dense_ic.py``), shared by ``probes/dense_ic_probe.py``,
``chip_smoke.py`` phase 17 and ``tests/test_torch_dense_ic.py``. It
imports the port alone (neither JAX nor a script), so each of them
imports it and nothing imports them back.

Shapes: ``nc`` is one stream at 512x384 with the frame step's dense
subsampling (2, 2, 1), 49,152 / 12,288 / 12,288 points at levels 0 / 1 /
2; ``fleet`` is 8 streams (the pool's scenes) with the pool's (4, 4, 1),
12,288 / 3,072 / 12,288 points each. Each cloud is ``_cloud_state`` of a
rendered frame 0 (the block matcher's disparity), evaluated on frame 1's
pyramid at the identity and at a nearby pose (``poses``).

``level_line`` holds the kernel to its references on one level and
times it:
- ``vs_plain``: the kernel against the plain version as the program ran
  it before (per call in nc, vmapped over the streams in fleet): the
  largest differences of H, b and chi2, each over the largest |entry|;
- ``vs_f64``: against the plain version's own per-point mask and
  residuals summed in float64 (the kernel sums in float64 too, so this
  is its rounding alone), and the share of the plain version's projected
  points whose u or v differs from the kernel's order of operations;
- ``one_point``: the contribution of the median in-frame point to the
  trace of H, over the trace (what a dropped point would move);
- ``vmap_equal`` (B > 1): the batched call bit-equal to per-lane calls;
- ``graph_equal``: 31 kernel calls captured in a CUDA graph, two replays
  and the eager calls bit-equal; the launch counter's calls per replay;
- times, by the caller's timer: one call eager and per call in a graph
  of 31, the kernel and the plain version, beside the bytes bound (41 B
  a point and the image once, at 3.35 TB/s).
"""

import numpy as np
import torch

from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.core.lie import SE3
from scavislam_tpu_torch.io.synthetic import (
    SyntheticSequence,
    closed_box,
    varied_box,
)
from scavislam_tpu_torch.models import frontend_step as FS
from scavislam_tpu_torch.ops import dense_ic, stereo_bm
from scavislam_tpu_torch.ops.image import binomial3, build_pyramid, sobel_xy
from scavislam_tpu_torch.utils.config import Config

CELLS = {"nc": (1, FS.DENSE_SUBS), "fleet": (8, FS.DENSE_SUBS_BATCHED)}
GRAPH_CALLS = 31  # one level's evaluations: 1 before the trips, 30 in them
HBM_BYTES_PER_S = 3.35e12
BYTES_PER_POINT = 12 + 4 + 24 + 1  # xyz, i_ref, J, valid


def camera():
    cfg = Config()
    return StereoCamera.create(cfg.cam.f, (cfg.cam.px, cfg.cam.py),
                               (cfg.cam.width, cfg.cam.height),
                               cfg.cam.baseline)


def cell_levels(dev, streams, subs):
    """Per level: (cam, img (B, h, w), xyz (B, N, 3), i_ref (B, N),
    J (B, N, 6), valid (B, N)) of `streams` scenes (the pool phase's:
    stream 0 closed_box(), the others varied_box(s)), frame 0's cloud on
    frame 1's image."""
    cam = camera()
    cams = [cam.scale_level(lv) for lv in range(3)]
    cam_params = tuple((c.focal, c.pp[0], c.pp[1], c.baseline) for c in cams)
    eye = torch.eye(3, device=dev)
    zero = torch.zeros(3, device=dev)
    per_stream = []
    for planes in [closed_box()] + [varied_box(s) for s in range(1, streams)]:
        seq = SyntheticSequence(cam, n_frames=2, kind="wander",
                                planes=planes, step=0.06, device=dev)
        f0, f1 = seq.frame(0), seq.frame(1)
        pyr0 = build_pyramid(f0["left"], 3)
        dxs, dys = zip(*[sobel_xy(p) for p in pyr0])
        disp = stereo_bm.block_matching_disparity_bm(
            binomial3(f0["left"]), binomial3(f0["right"]), 64)
        clouds, valids, intens, Js = FS._cloud_state(
            pyr0, disp, eye, zero, cam_params, 3, dxs, dys, subs)
        per_stream.append((build_pyramid(f1["left"], 3), clouds, intens, Js,
                           valids))
    return [(cams[lv],) + tuple(torch.stack([s[k][lv] for s in per_stream])
                                for k in range(5)) for lv in range(3)]


def poses(dev, streams):
    """[(R (B, 3, 3), t (B, 3))] at the identity and at a nearby pose
    (each stream its own, t up to ~1 cm)."""
    eye = torch.eye(3, device=dev).expand(streams, 3, 3).contiguous()
    zero = torch.zeros(streams, 3, device=dev)
    d = np.random.default_rng(7).normal(0, 0.003, (streams, 6))
    T = [SE3.exp(torch.as_tensor(x, dtype=torch.float32, device=dev))
         for x in d]
    return [(eye, zero), (torch.stack([x.R for x in T]),
                          torch.stack([x.t for x in T]))]


def plain_lane(cam, img, R, t, c, i, J, v):
    return dense_ic.ic_pass_plain(img, R, t, c, i, J, v, cam.focal, cam.pp)


def kernel_lane(cam, img, R, t, c, i, J, v):
    return dense_ic.ic_pass(img, R, t, c, i, J, v, cam.focal, cam.pp)


def over_lanes(fn, cam, args):
    """`fn` per lane as the program calls it: vmapped over B > 1 lanes."""
    if args[0].shape[0] == 1:
        return tuple(x[None] for x in fn(cam, *(a[0] for a in args)))
    return torch.func.vmap(lambda *a: fn(cam, *a))(*args)


def f64_reference(cam, img, R, t, c, i, J, v):
    """The plain version's per-point mask and residual, summed in float64:
    ((H, b, chi2), uv, camera-frame points, in-frame mask)."""
    h, w = img.shape
    xyz = c @ R.T + t
    z, uv = dense_ic.project(cam.focal, cam.pp, xyz)
    i_cur, _ = dense_ic.sample_exact(img, h, w, uv)
    inside = dense_ic.in_frame(uv, z, w, h, v)
    res = torch.clamp(i - i_cur, -dense_ic.RES_CLAMP, dense_ic.RES_CLAMP)
    res = torch.where(inside, res, torch.zeros_like(res)).double()
    Jm = torch.where(inside[:, None], J, torch.zeros_like(J)).double()
    return (Jm.T @ Jm, Jm.T @ res, (res * res).sum()), uv, xyz, inside


def kernel_order_uv(cam, R, t, c):
    """u, v in the kernel's order: x R0, then y R1 and z R2 by fused
    multiply-add (emulated in float64, exact for one product plus one
    rounding), then + t, then / z * f + pp, each rounded to float32."""
    c64, R64 = c.double(), R.double()
    rows = []
    for r in range(3):
        acc = (c64[:, 0] * R64[r, 0]).float()
        for k in (1, 2):
            acc = (c64[:, k] * R64[r, k] + acc.double()).float()
        rows.append(acc + t[r])
    u = rows[0] / rows[2] * cam.focal + cam.pp[0]
    v = rows[1] / rows[2] * cam.focal + cam.pp[1]
    return torch.stack([u, v], -1)


def rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def graph_of(fn, recorded=None):
    """fn captured as a CUDA graph after a warm-up on a side stream:
    (graph, outputs of the captured call); the counted calls of the
    capture alone go into `recorded`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    stereo_bm.CAPTURED.calls = recorded
    try:
        with torch.cuda.graph(graph):
            out = fn()
    finally:
        stereo_bm.CAPTURED.calls = None
    return graph, out


def level_line(level, R, t, cuda_ms):
    """The numbers above for one level (``cell_levels``' entry) at the
    pose (R, t) (B, ...); `cuda_ms(fn, runs)` times a call."""
    cam, img, c, i, J, v = level
    B, n = c.shape[0], c.shape[1]
    args = (img, R, t, c, i, J, v)
    k = over_lanes(kernel_lane, cam, args)
    p = over_lanes(plain_lane, cam, args)
    torch.cuda.synchronize()
    out = {"vs_plain": [rel(k[j], p[j]) for j in range(3)],
           "vs_plain_abs": max(float((k[j] - p[j]).abs().max())
                               for j in range(3))}
    ref_rel, uv_diff, contrib = [0.0, 0.0, 0.0], 0, []
    for b in range(B):
        ref, uv, xyz, inside = f64_reference(cam, img[b], R[b], t[b], c[b],
                                             i[b], J[b], v[b])
        ref_rel = [max(ref_rel[j], rel(k[j][b], ref[j])) for j in range(3)]
        uv_k = kernel_order_uv(cam, R[b], t[b], c[b])
        finite = v[b] & torch.isfinite(uv).all(-1)
        uv_diff += int((uv_k != uv).any(-1)[finite].sum())
        Jin = J[b][inside].double()
        if Jin.shape[0]:
            contrib.append(float((Jin * Jin).sum(-1).median()
                                 / (Jin * Jin).sum()))
        out.setdefault("in_frame", []).append(int(inside.sum()))
    out["vs_f64"] = ref_rel
    out["uv_differ"] = uv_diff
    out["one_point"] = min(contrib) if contrib else None
    if B > 1:
        lanes = [kernel_lane(cam, *(a[b] for a in args)) for b in range(B)]
        out["vmap_equal"] = all(torch.equal(k[j][b], lanes[b][j])
                                for b in range(B) for j in range(3))
    calls = lambda fn: [over_lanes(fn, cam, args)  # noqa: E731
                        for _ in range(GRAPH_CALLS)]
    recorded = []
    g_k, outs_k = graph_of(lambda: calls(kernel_lane), recorded)
    g_k.replay()
    first = [tuple(x.clone() for x in o) for o in outs_k]
    g_k.replay()
    torch.cuda.synchronize()
    out["graph_equal"] = all(
        torch.equal(a, b) and torch.equal(a, e)
        for o1, o2 in zip(first, outs_k) for a, b, e in zip(o1, o2, k))
    out["captured_per_replay"] = len(recorded)
    g_p, _ = graph_of(lambda: calls(plain_lane))
    out["us_graph_kernel"] = 1e3 * cuda_ms(g_k.replay, 10) / GRAPH_CALLS
    out["us_graph_plain"] = 1e3 * cuda_ms(g_p.replay, 10) / GRAPH_CALLS
    out["us_eager_kernel"] = 1e3 * cuda_ms(
        lambda: over_lanes(kernel_lane, cam, args), 25)
    out["us_eager_plain"] = 1e3 * cuda_ms(
        lambda: over_lanes(plain_lane, cam, args), 25)
    h, w = img.shape[1:]
    out["bound_us"] = 1e6 * B * (n * BYTES_PER_POINT + 4 * h * w) \
        / HBM_BYTES_PER_S
    out["n"], out["B"], out["image"] = n, B, [h, w]
    return out

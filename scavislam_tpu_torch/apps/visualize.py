"""Headless map / trajectory / debug views (port of
scavislam_tpu.apps.visualize).

The replacement for the reference's Pangolin GUI (stereo_slam.cpp:124-642:
image pyramids, keyframe views, 3-D map view, timing plot) on a machine with
no display: the map top-down with keyframes, edges, map points, the
trajectory and the ground truth; the camera image with its tracked
features; the GUI's 7-way debug view; a keyframe's image with its anchored
points; the stacked per-stage timing plot.

Every render function returns an (H, W, 3) uint8 numpy array and writes it
as a PNG (utils/png.py) when given ``path``. The drawings are built as a
list of primitives in pixel coordinates and drawn by the port's own
rasterizer (utils/raster.py), which follows PIL's integer rules; no imaging
library is used. The debug views compute on the device that holds the
frontend's tensors and download the finished image once.
"""

from __future__ import annotations

import numpy as np
import torch

from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.models.slam_graph import APPEARANCE, LOCAL, METRIC
from scavislam_tpu_torch.utils.png import write_png
from scavislam_tpu_torch.utils.raster import Prim, blank, rasterize

EDGE_COLORS = {
    LOCAL: (90, 110, 230),
    METRIC: (80, 200, 120),
    APPEARANCE: (240, 120, 70),
}
BACKGROUND = (18, 18, 24)


def _done(img: np.ndarray, path):
    if path:
        write_png(path, img)
    return img


def _to_px(xy, bounds, size, margin=30):
    (x0, x1), (z0, z1) = bounds
    w, h = size
    sx = (w - 2 * margin) / max(x1 - x0, 1e-6)
    sz = (h - 2 * margin) / max(z1 - z0, 1e-6)
    s = min(sx, sz)
    return (
        margin + (xy[0] - x0) * s,
        h - margin - (xy[1] - z0) * s,
    )


def _host(a) -> np.ndarray:
    """A pose field as numpy (device tensors, e.g. a synthetic sequence's
    ground truth on the card, are downloaded)."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _center_xz(T):
    c = -_host(T.R).T @ _host(T.t)
    return float(c[0]), float(c[2])


def map_topdown_prims(graph, trajectory=None, gt_poses=None,
                      size=(900, 900)) -> list:
    """The primitives of the top-down (x-z) view of a graph (anything with
    ``vertices``, ``points`` and ``edges`` as SlamGraph has them)."""
    kf_xy = {}
    for k, v in graph.vertices.items():
        T_wc_t = -v.R.T @ v.t  # camera center in world
        kf_xy[k] = (float(T_wc_t[0]), float(T_wc_t[2]))
    pts = []
    for p in graph.points.values():
        if p.anchor_id in graph.vertices:
            v = graph.vertices[p.anchor_id]
            xyz_a = np.array([p.psi[0] / p.psi[2], p.psi[1] / p.psi[2],
                              1.0 / p.psi[2]])
            xyz_w = v.R.T @ (xyz_a - v.t)
            pts.append((float(xyz_w[0]), float(xyz_w[2])))

    all_xy = list(kf_xy.values()) + pts
    if trajectory:
        all_xy += [_center_xz(T) for _fid, T in trajectory]
    if not all_xy:
        return []
    xs = [p[0] for p in all_xy]
    zs = [p[1] for p in all_xy]
    bounds = ((min(xs), max(xs)), (min(zs), max(zs)))

    prims = [Prim("point", (_to_px(p, bounds, size),), fill=(120, 120, 130))
             for p in pts]
    for (a, b), e in graph.edges.items():
        if a in kf_xy and b in kf_xy:
            color = EDGE_COLORS.get(e.edge_type, (150, 150, 150))
            if e.is_marginalized():
                color = tuple(c // 2 for c in color)
            prims.append(Prim("line", (_to_px(kf_xy[a], bounds, size),
                                       _to_px(kf_xy[b], bounds, size)),
                              fill=color, width=1))
    if gt_poses:
        pts_gt = tuple(_to_px(_center_xz(T), bounds, size) for T in gt_poses)
        if len(pts_gt) > 1:
            prims.append(Prim("line", pts_gt, fill=(90, 90, 90), width=2))
    if trajectory:
        pts_est = tuple(_to_px(_center_xz(T), bounds, size)
                        for _fid, T in trajectory)
        if len(pts_est) > 1:
            prims.append(Prim("line", pts_est, fill=(250, 210, 60),
                              width=2))
    for xy in kf_xy.values():  # keyframes on top
        x, y = _to_px(xy, bounds, size)
        prims.append(Prim("ellipse", ((x - 3, y - 3), (x + 3, y + 3)),
                          fill=(240, 240, 255)))
    return prims


def render_map_topdown(graph, trajectory=None, gt_poses=None,
                       size=(900, 900), path=None) -> np.ndarray:
    """Top-down (x-z) view of the SLAM graph, (size[1], size[0], 3)."""
    img = blank(size, BACKGROUND)
    rasterize(img, map_topdown_prims(graph, trajectory, gt_poses, size))
    return _done(img, path)


def _u8_rgb(a01: torch.Tensor) -> torch.Tensor:
    """[0, 1] float (H, W) or (H, W, 3) -> (H, W, 3) uint8 on the same
    device, truncating as the twin's astype(np.uint8)."""
    u = (torch.clamp(a01.to(torch.float32), 0.0, 1.0) * 255).to(torch.uint8)
    return u if u.ndim == 3 else u[..., None].expand(*u.shape, 3).contiguous()


def _to_img(arr01) -> np.ndarray:
    """A [0, 1] gray or RGB image (numpy, or a tensor on any device: one
    download) as (H, W, 3) uint8."""
    t = arr01 if isinstance(arr01, torch.Tensor) else torch.as_tensor(
        np.asarray(arr01, np.float32))
    return _u8_rgb(t).cpu().numpy()


def overlay_prims(tracked_uv=None, corners_uv=None) -> list:
    prims = []
    if corners_uv is not None:
        prims += [Prim("point", ((float(u), float(v)),), fill=(90, 110, 230))
                  for u, v in np.asarray(corners_uv)]
    if tracked_uv is not None:
        prims += [Prim("ellipse", ((u - 2, v - 2), (u + 2, v + 2)),
                       outline=(80, 220, 120))
                  for u, v in np.asarray(tracked_uv)]
    return prims


def render_frame_overlay(left_img01, tracked_uv=None, corners_uv=None,
                         path=None) -> np.ndarray:
    """Camera image with tracked features (the reference's left view with
    DrawItems overlays, stereo_slam.cpp:267-333)."""
    img = rasterize(_to_img(left_img01),
                    overlay_prims(tracked_uv, corners_uv))
    return _done(img, path)


# --------------------------------------------------------------------- #
# debug image modes (parity: the reference GUI's ui.debug 0-6 selector +
# ui.debug_level, stereo_slam.cpp:267-333)
# --------------------------------------------------------------------- #

DEBUG_MODES = (
    "residual", "cur_pyr", "prev_pyr", "dx", "dy", "right", "color_disp",
)


def _hsv_disp(disp: torch.Tensor, num_disp: int) -> torch.Tensor:
    """(H, W, 3) uint8 of the HSV-mapped disparity on disp's device: the
    hue byte is disparity x 180 / num_disp (clipped to 0-179, as the
    reference's OpenCV hue), saturation 255, value 255 where valid; then
    PIL's HSV -> RGB in integer arithmetic. With s = 255, PIL's p is 0 and
    its t and q are v*f and v*(1 - f) rounded, f the hue's remainder in a
    sixth of the 0-255 circle; for v in {0, 255} they are exact."""
    d = disp.to(torch.float32)
    hue = torch.clamp(d * (180.0 / max(num_disp, 1)), 0, 179).to(torch.int32)
    v = torch.where(d > 0, 255, 0).to(torch.int32)
    sector = (6 * hue) // 255
    rem = 6 * hue - 255 * sector
    t = (v * rem + 127) // 255
    q = v - t
    p = torch.zeros_like(v)
    table = torch.stack([
        torch.stack([v, t, p], -1), torch.stack([q, v, p], -1),
        torch.stack([p, v, t], -1), torch.stack([p, q, v], -1),
        torch.stack([t, p, v], -1), torch.stack([v, p, q], -1)])
    idx = (sector % 6)[None, ..., None].expand(1, *sector.shape, 3)
    return torch.gather(table, 0, idx)[0].to(torch.uint8)


def disparity_hsv(disp, num_disp=64) -> np.ndarray:
    """HSV-mapped disparity like the reference's color_disp view
    (cv::gpu::drawColorDisp / the CPU HSV merge, stereo_frontend.cpp:
    645-655): hue encodes disparity, invalid (<= 0) renders black."""
    d = disp if isinstance(disp, torch.Tensor) else torch.as_tensor(
        np.asarray(disp, np.float32))
    return _hsv_disp(d, num_disp).cpu().numpy()


def _last_wins(values: torch.Tensor, flat: torch.Tensor, n: int):
    """For each of n pixels, the value of the LAST entry whose flat index
    hits it (numpy's fancy-assignment order), and whether any does. An
    index of n is a dump slot."""
    order = torch.arange(flat.numel(), device=flat.device)
    win = torch.full((n + 1,), -1, dtype=torch.long, device=flat.device)
    win.scatter_reduce_(0, flat, order, reduce="amax")
    win = win[:n]
    return values[win.clamp(min=0)], win >= 0


def _residual_rgb(cam, img, cloud_xyz, intens, valid, R, t, clamp=0.1):
    """(H, W, 3) f32 of residual_image, on the tensors' device."""
    img = img.to(torch.float32)
    h, w = img.shape
    out = (torch.stack([img, img, img], -1) * 0.5).reshape(h * w, 3)
    x_c = cloud_xyz @ R.T + t
    z = x_c[:, 2]
    u = cam.focal * x_c[:, 0] / z + cam.pp[0]
    v = cam.focal * x_c[:, 1] / z + cam.pp[1]
    valid = valid.to(torch.bool)
    ok = (valid & (z > 1e-6) & (u >= 0) & (u <= w - 1) & (v >= 0)
          & (v <= h - 1))
    oob = valid & ~ok
    dump = torch.full_like(z, h * w, dtype=torch.long)

    ui = torch.clamp(torch.nan_to_num(u), 0, w - 1).to(torch.long)
    vi = torch.clamp(torch.nan_to_num(v), 0, h - 1).to(torch.long)
    hit = vi * w + ui
    r = torch.abs(img.reshape(-1)[hit] - intens)
    m = torch.clamp(r / clamp, 0.0, 1.0)
    col, got = _last_wins(torch.stack([m, 1.0 - m, torch.zeros_like(m)], -1),
                          torch.where(ok, hit, dump), h * w)
    out = torch.where(got[:, None], col, out)
    # blue: valid points that left the view (the reference's invalid color)
    blue = torch.full((z.numel(), 3), 0.2, device=out.device)
    blue[:, 2] = 1.0
    col, got = _last_wins(blue, torch.where(oob, hit, dump), h * w)
    out = torch.where(got[:, None], col, out)
    return out.reshape(h, w, 3)


def residual_image(cam, img_level01, cloud_xyz, intens, valid, R, t,
                   clamp=0.1) -> np.ndarray:
    """Photometric-residual view of the dense tracker's state (parity:
    GpuTracker::residualImage, gpu/dense_tracking.cu:494-541: each tracked
    pixel green..red by |residual|, blue where the point projects out of
    view). Computed on the tensors' device; one download."""
    img = torch.as_tensor(img_level01)
    dev = img.device

    def t_(x):
        return (x.to(dev) if isinstance(x, torch.Tensor)
                else torch.as_tensor(np.array(x), device=dev))

    out = _residual_rgb(cam, img, t_(cloud_xyz).to(torch.float32),
                        t_(intens).to(torch.float32), t_(valid),
                        t_(R).to(torch.float32), t_(t).to(torch.float32),
                        clamp)
    return _u8_rgb(out).cpu().numpy()


def render_debug_image(mode: int, level: int, frontend, num_disp=64,
                       path=None) -> np.ndarray:
    """The reference GUI's 7-way debug view (ui.debug, ui.debug_level) from
    the frontend's device state of its last dispatched frame. The view is
    computed on the frontend's device and downloaded once."""
    pyr = frontend.last_pyr
    lvl = min(level, len(pyr) - 1)
    name = DEBUG_MODES[mode]
    if name == "residual":
        focal, ppx, ppy, baseline = frontend._cam_params[lvl]
        cam_l = StereoCamera.create(focal, (ppx, ppy),
                                    frontend._cam_statics[lvl], baseline)
        dev = pyr[lvl].device
        rgb = _u8_rgb(_residual_rgb(
            cam_l, pyr[lvl], frontend._prev_clouds[lvl],
            frontend._prev_intens[lvl], frontend._prev_valids[lvl],
            torch.eye(3, dtype=torch.float32, device=dev),
            torch.zeros(3, dtype=torch.float32, device=dev)))
    elif name == "cur_pyr":
        rgb = _u8_rgb(pyr[lvl])
    elif name == "prev_pyr":
        prev = frontend.prev_pyr
        rgb = _u8_rgb(prev[lvl] if prev is not None else pyr[lvl])
    elif name == "dx":
        rgb = _u8_rgb(frontend.last_dx[lvl] * 2.0 + 0.5)
    elif name == "dy":
        rgb = _u8_rgb(frontend.last_dy[lvl] * 2.0 + 0.5)
    elif name == "right":
        arr = frontend.last_right
        if arr.dtype == torch.uint8:
            arr = arr.to(torch.float32) / 255.0
        rgb = _u8_rgb(arr)
    else:  # color_disp
        rgb = _hsv_disp(frontend.last_disp, num_disp)
    return _done(rgb.cpu().numpy(), path)


def keyframe_prims(frontend, kf_id: int) -> list:
    """The keyframe view's primitives: an outline circle at each map point
    anchored in the keyframe (psi = (x/z, y/z, 1/z) in the anchor frame,
    projected directly)."""
    ids = frontend.kf_point_ids.get(kf_id, np.zeros(0, np.int64))
    if not len(ids):
        return []
    anchor = frontend._meta_anchor
    anchored = ids[anchor[np.clip(ids, 0, len(anchor) - 1)] == kf_id]
    if not len(anchored):
        return []
    psi_t = frontend.points.psi
    psi = psi_t[torch.as_tensor(anchored, device=psi_t.device)].cpu().numpy()
    focal, ppx, ppy, _ = (float(x) for x in np.asarray(
        frontend._cam_params[0], np.float32))
    u = focal * psi[:, 0] + ppx
    v = focal * psi[:, 1] + ppy
    return [Prim("ellipse", ((uu - 2, vv - 2), (uu + 2, vv + 2)),
                 outline=(250, 210, 60)) for uu, vv in zip(u, v)]


def render_keyframe_view(frontend, kf_id: int, path=None) -> np.ndarray:
    """A keyframe's image with its anchored map points (parity: the GUI's
    ui.show_keyframe pyramid views, stereo_slam.cpp:253-257, 567-607)."""
    kf = frontend.keyframe_map[kf_id]
    if "pyr" not in kf:
        raise KeyError(
            f"keyframe {kf_id} has no stored image: set "
            "frontend.keep_kf_images = True before the run (retention is "
            "off by default to bound device memory on long runs)")
    img = _to_img(kf["pyr"][0])
    return _done(rasterize(img, keyframe_prims(frontend, kf_id)), path)


# stage palette for the stacked timing plot
_STAGE_COLORS = [
    (96, 146, 222), (222, 146, 96), (120, 200, 120), (200, 120, 200),
    (222, 200, 96), (96, 222, 200), (160, 160, 160), (222, 96, 120),
    (140, 120, 220), (180, 220, 96), (96, 180, 120),
]


def timing_prims(per_mon, size=(900, 360)) -> list:
    """The stacked timing plot's bars, legend and scale label."""
    hist = per_mon.history
    if not hist:
        return []
    stages = [n for n in per_mon._names
              if any(h.get(n, 0.0) > 0 for h in hist)]
    w, h = size
    margin = 28
    n = len(hist)
    totals = [sum(f.get(s, 0.0) for s in stages) for f in hist]
    y_max = max(max(totals), 1e-6) * 1.1
    bar_w = max(1, (w - 2 * margin) // max(n, 1))
    prims = []
    for i, f in enumerate(hist):
        x0 = margin + i * bar_w
        if x0 + bar_w > w - margin:
            break
        y = h - margin
        for si, s in enumerate(stages):
            dt = f.get(s, 0.0)
            if dt <= 0:
                continue
            hh = dt / y_max * (h - 2 * margin)
            prims.append(Prim("rectangle", ((x0, y - hh), (x0 + bar_w - 1, y)),
                              fill=_STAGE_COLORS[si % len(_STAGE_COLORS)]))
            y -= hh
    ly = margin // 2
    lx = margin
    for si, s in enumerate(stages):
        prims.append(Prim("rectangle", ((lx, ly), (lx + 8, ly + 8)),
                          fill=_STAGE_COLORS[si % len(_STAGE_COLORS)]))
        prims.append(Prim("text", ((lx + 12, ly - 2),), fill=(220, 220, 220),
                          text=s))
        lx += 12 + 7 * len(s) + 14
        if lx > w - 120:
            lx, ly = margin, ly + 14
    prims.append(Prim("text", ((w - margin - 130, margin // 2),),
                      fill=(220, 220, 220), text=f"ymax {y_max*1e3:.1f} ms"))
    return prims


def render_timing_plot(per_mon, size=(900, 360), path=None) -> np.ndarray:
    """Stacked per-stage timing histogram over frames (parity: the
    reference's live plotter fed by PerformanceMonitor,
    stereo_slam.cpp:155-160, 635-637)."""
    img = blank(size, BACKGROUND)
    return _done(rasterize(img, timing_prims(per_mon, size)), path)

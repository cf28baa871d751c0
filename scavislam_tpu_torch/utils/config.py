"""Typed configuration with the reference's key names and file format.

Replaces the reference's Pangolin ``Var<T>`` global key-value store
(the reference ScaViSLAM code pulls config keys ad hoc throughout, e.g.
stereo_frontend.cpp:52-89, backend.cpp:141-147, frame_grabber.cpp:196-243;
files parsed by pangolin::ParseVarsFile, stereo_slam.cpp:654).

Here configuration is a frozen dataclass tree with code defaults identical to
the reference's, plus a parser for the reference's ``key = value;`` cfg file
dialect (``//`` comments, stray whitespace/tabs, trailing semicolons) so the
shipped configs (data/newcollege.cfg etc.) load unmodified.

Note: the reference parses but never uses ``num_frames_metric_loop_check``,
``save_dense_cloud`` and ``mask_img`` (SURVEY.md §5); we accept them for
config compatibility and likewise ignore them.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field


@dataclass(frozen=True)
class CameraConfig:
    width: int = 512
    height: int = 384
    f: float = 389.956085
    px: float = 254.903519
    py: float = 201.899490
    baseline: float = 0.120005
    # distortion / rectification rotations (rgbd_example.cfg:1-22)
    dist_left: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)
    dist_right: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)
    rot_left: tuple = (0.0, 0.0, 0.0)
    rot_right: tuple = (0.0, 0.0, 0.0)


@dataclass(frozen=True)
class FramePipeConfig:
    livestream: bool = False
    path_str: str = ""
    base_str: str = ".*"
    format_str: str = "png"
    skip_imgs: int = 0
    color_img: bool = False
    right_img: bool = True
    disp_img: bool = False
    depth_img: bool = False
    rectify_frame: bool = False
    mask_img: bool = False  # parsed-but-unused in the reference too


@dataclass(frozen=True)
class FrontendConfig:
    covis_thr: int = 15
    new_keyframe_pixel_thr: int = 70
    new_keyframe_featureless_corners_thr: int = 2
    num_frames_metric_loop_check: int = 50  # parsed-but-unused (parity)
    newpoint_clearance: int = 2
    save_dense_cloud: bool = True  # parsed-but-unused (parity)


@dataclass(frozen=True)
class GraphConfig:
    inner_window: int = 15
    outer_window: int = 100
    # Device index for the DWO solve, -1 = the default (tracking) device.
    # On a multi-chip host the solve can run on a sibling chip so backend
    # optimization never timeshares the tracking chip — the device-level
    # analogue of the reference running its optimizer in a separate backend
    # thread on its own CPU core (backend.cpp thread loop). No reference
    # .cfg key (single-GPU era); accepted as `graph.solve_device`.
    solve_device: int = -1
    # Number of devices to shard the DWO solve's OBSERVATION axis over
    # (partial normal equations per shard + one psum over ICI — see
    # slam_graph._sharded_packed_solver). 0/1 = single-device solve.
    # Ignored (with a warning) when fewer devices exist. No reference
    # .cfg key (single-node g2o era); accepted as `graph.solve_mesh`.
    solve_mesh: int = 0


@dataclass(frozen=True)
class UIConfig:
    parallax_thr: float = 0.75
    max_reproj_error: float = 2.0
    num_max_points: int = 300
    min_num_points: int = 15
    stereo_method: int = 2  # 1 CPU-BM twin / 2 BM (default) / 3 BP / 4 CSBP
    num_disp16: int = 4  # x16 disparities
    # BP/CSBP knobs (reference: ui.stereo_iters/levels/nr_plane Vars,
    # stereo_frontend.cpp:597-600)
    stereo_iters: int = 4
    stereo_levels: int = 4
    stereo_nr_plane: int = 4


@dataclass(frozen=True)
class Config:
    cam: CameraConfig = field(default_factory=CameraConfig)
    framepipe: FramePipeConfig = field(default_factory=FramePipeConfig)
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    graph: GraphConfig = field(default_factory=GraphConfig)
    ui: UIConfig = field(default_factory=UIConfig)
    use_n_levels_in_frontent: int = 3  # sic — reference's key spelling


_LINE = re.compile(r"^\s*([A-Za-z0-9_.]+)\s*=\s*(.*?)\s*;?\s*$")


def parse_vars_file(path: str) -> dict:
    """Parse the reference cfg dialect into a flat {key: string} dict."""
    out = {}
    with open(path) as f:
        for raw in f:
            line = raw.split("//")[0].strip()
            if not line:
                continue
            m = _LINE.match(line)
            if m:
                out[m.group(1)] = m.group(2)
    return out


def _coerce(val: str, target):
    if isinstance(target, bool):
        return val.strip() in ("1", "true", "True")
    if isinstance(target, int):
        return int(float(val))
    if isinstance(target, float):
        return float(val)
    return val.strip()


def load_config(path: str) -> Config:
    """Load a reference-format cfg file over the code defaults."""
    flat = parse_vars_file(path)
    cfg = Config()

    def apply(section_obj, prefix):
        updates = {}
        for f_ in dataclasses.fields(section_obj):
            key = f"{prefix}.{f_.name}" if prefix else f_.name
            if key in flat:
                updates[f_.name] = _coerce(flat[key], getattr(section_obj, f_.name))
        return dataclasses.replace(section_obj, **updates) if updates else section_obj

    cam = apply(cfg.cam, "cam")
    # distortion / rotation vectors use numbered keys
    def vec(prefix, n):
        vals = []
        found = False
        for i in range(1, n + 1):
            k = f"{prefix}{i}"
            if k in flat:
                vals.append(float(flat[k]))
                found = True
            else:
                vals.append(0.0)
        return (tuple(vals), found)

    dl, f1 = vec("cam.dist_left", 5)
    dr, f2 = vec("cam.dist_right", 5)
    if f1 or f2:
        cam = dataclasses.replace(cam, dist_left=dl, dist_right=dr)
    rl = tuple(
        float(flat.get(f"cam.rot{a}_left", 0.0)) for a in ("x", "y", "z")
    )
    rr = tuple(
        float(flat.get(f"cam.rot{a}_right", 0.0)) for a in ("x", "y", "z")
    )
    cam = dataclasses.replace(cam, rot_left=rl, rot_right=rr)

    ui = apply(cfg.ui, "ui")
    # newcollege.cfg spells one key "ui_parallax_thr" (sic)
    if "ui_parallax_thr" in flat:
        ui = dataclasses.replace(ui, parallax_thr=float(flat["ui_parallax_thr"]))

    top = cfg
    if "use_n_levels_in_frontent" in flat:
        top = dataclasses.replace(
            top, use_n_levels_in_frontent=int(float(flat["use_n_levels_in_frontent"]))
        )

    return dataclasses.replace(
        top,
        cam=cam,
        framepipe=apply(cfg.framepipe, "framepipe"),
        frontend=apply(cfg.frontend, "frontend"),
        graph=apply(cfg.graph, "graph"),
        ui=ui,
    )

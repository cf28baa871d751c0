"""The port's configuration and camera for a benchmark configuration."""

from __future__ import annotations


def program_config(config: dict):
    """(scavislam_tpu_torch Config, StereoCamera) of a configuration file:
    its camera, and its stereo method, disparities, reprojection limit and
    DWO windows where it gives them (a monocular configuration gives no
    stereo keys); every other setting the port's default."""
    from scavislam_tpu_torch.core.camera import StereoCamera
    from scavislam_tpu_torch.utils.config import (
        CameraConfig,
        Config,
        GraphConfig,
        UIConfig,
    )

    c = config["camera"]
    ui = {k: config[k] for k in ("stereo_method", "max_reproj_error")
          if k in config}
    if "num_disp" in config:
        ui["num_disp16"] = config["num_disp"] // 16
    cfg = Config(cam=CameraConfig(width=c["width"], height=c["height"],
                                  f=c["f"], px=c["px"], py=c["py"],
                                  baseline=c["baseline"]),
                 graph=GraphConfig(**config.get("graph", {})),
                 ui=UIConfig(**ui))
    cam = StereoCamera.create(cfg.cam.f, (cfg.cam.px, cfg.cam.py),
                              (cfg.cam.width, cfg.cam.height),
                              cfg.cam.baseline)
    return cfg, cam

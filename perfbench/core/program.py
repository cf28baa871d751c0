"""The port's configuration and camera for a benchmark configuration."""

from __future__ import annotations


def program_config(config: dict):
    """(scavislam_tpu_torch Config, StereoCamera) of a configuration file:
    its camera, stereo method, disparities, reprojection limit and DWO
    windows (where given); every other setting the port's default."""
    from scavislam_tpu_torch.core.camera import StereoCamera
    from scavislam_tpu_torch.utils.config import (
        CameraConfig,
        Config,
        GraphConfig,
        UIConfig,
    )

    c = config["camera"]
    cfg = Config(cam=CameraConfig(width=c["width"], height=c["height"],
                                  f=c["f"], px=c["px"], py=c["py"],
                                  baseline=c["baseline"]),
                 graph=GraphConfig(**config.get("graph", {})),
                 ui=UIConfig(stereo_method=config["stereo_method"],
                             num_disp16=config["num_disp"] // 16,
                             max_reproj_error=config["max_reproj_error"]))
    cam = StereoCamera.create(cfg.cam.f, (cfg.cam.px, cfg.cam.py),
                              (cfg.cam.width, cfg.cam.height),
                              cfg.cam.baseline)
    return cfg, cam

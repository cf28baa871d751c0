"""Pinhole stereo camera (port of scavislam_tpu.core.camera.StereoCamera).

The stereo observation is the 3-vector ``uvu`` = (u_left, v, u_right). The
intrinsics are host scalars held as Python floats that are exactly float32
values, so tensor arithmetic with them is the twin's f32 arithmetic on any
device (``create`` and ``scale_level`` round through numpy float32, as the
twin's f32 scalars do).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _f32(x) -> float:
    return float(np.float32(x))


class StereoCamera(NamedTuple):
    """Calibrated rectified stereo rig; observations are uvu triplets."""

    focal: float
    pp: tuple  # (px, py)
    size: tuple  # (width, height)
    baseline: float

    @staticmethod
    def create(focal, pp, size, baseline) -> "StereoCamera":
        pp = np.asarray(pp, np.float32).reshape(2)
        return StereoCamera(
            _f32(focal), (float(pp[0]), float(pp[1])),
            (int(size[0]), int(size[1])), _f32(baseline),
        )

    def map_uvu(self, xyz: torch.Tensor) -> torch.Tensor:
        """Camera-frame 3-D points (..., 3) -> (u_left, v, u_right)."""
        z = xyz[..., 2]
        u = xyz[..., 0] / z * self.focal + self.pp[0]
        v = xyz[..., 1] / z * self.focal + self.pp[1]
        u_r = (xyz[..., 0] - self.baseline) / z * self.focal + self.pp[0]
        return torch.stack([u, v, u_r], dim=-1)

    def unmap_uvu(self, uvu: torch.Tensor) -> torch.Tensor:
        """(u_left, v, u_right) -> camera-frame 3-D point."""
        disp = uvu[..., 0] - uvu[..., 2]
        z = _f32(np.float32(self.focal) * np.float32(self.baseline)) / disp
        x = (uvu[..., 0] - self.pp[0]) / self.focal * z
        y = (uvu[..., 1] - self.pp[1]) / self.focal * z
        return torch.stack([x, y, z], dim=-1)

    def scale_level(self, level: int) -> "StereoCamera":
        """Camera for pyramid level `level`: focal and principal point halve
        per level, the baseline DOUBLES, so f*b (hence the disparity value
        for a given depth) is level-invariant."""
        s = np.float32(2**level)
        f32 = np.float32
        return StereoCamera(
            float(f32(self.focal) / s),
            (float((f32(self.pp[0]) + f32(0.5)) / s - f32(0.5)),
             float((f32(self.pp[1]) + f32(0.5)) / s - f32(0.5))),
            (self.size[0] // (2**level), self.size[1] // (2**level)),
            float(f32(self.baseline) * s),
        )

"""Pinhole and stereo camera models (port of scavislam_tpu.core.camera).

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


def pp_tensor(cam, like: torch.Tensor) -> torch.Tensor:
    """A camera's principal point as a (2,) tensor of `like`'s dtype and
    device (the intrinsics are host floats)."""
    return torch.as_tensor(cam.pp, dtype=like.dtype, device=like.device)


class LinearCamera(NamedTuple):
    """Pinhole camera: one focal length, principal point, image size."""

    focal: float
    pp: tuple  # (px, py)
    size: tuple  # (width, height)

    @property
    def width(self):
        return self.size[0]

    @property
    def height(self):
        return self.size[1]

    def map(self, xy: torch.Tensor) -> torch.Tensor:
        """Normalized image plane (..., 2) -> pixels (..., 2)."""
        return xy * self.focal + pp_tensor(self, xy)

    def unmap(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixels (..., 2) -> normalized image plane (..., 2)."""
        return (uv - pp_tensor(self, uv)) / self.focal

    def project(self, xyz: torch.Tensor) -> torch.Tensor:
        """Camera-frame points (..., 3) -> pixels (..., 2)."""
        return self.map(xyz[..., :2] / xyz[..., 2:3])

    def intrinsics(self, device=None) -> torch.Tensor:
        """3x3 K matrix, float32."""
        f, (px, py) = self.focal, self.pp
        return torch.tensor([[f, 0.0, px], [0.0, f, py], [0.0, 0.0, 1.0]],
                            dtype=torch.float32, device=device)


class StereoCamera(NamedTuple):
    """Calibrated rectified stereo rig; observations are uvu triplets."""

    focal: float
    pp: tuple  # (px, py)
    size: tuple  # (width, height)
    baseline: float

    @property
    def width(self):
        return self.size[0]

    @property
    def height(self):
        return self.size[1]

    @property
    def mono(self) -> LinearCamera:
        return LinearCamera(self.focal, self.pp, self.size)

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
        z = self._fb() / disp
        x = (uvu[..., 0] - self.pp[0]) / self.focal * z
        y = (uvu[..., 1] - self.pp[1]) / self.focal * z
        return torch.stack([x, y, z], dim=-1)

    def _fb(self) -> float:
        return _f32(np.float32(self.focal) * np.float32(self.baseline))

    def uv_disp_to_xyz(self, u, v, disp) -> torch.Tensor:
        """Back-project (u, v, disparity) -> camera-frame xyz (broadcasting)."""
        z = self._fb() / disp
        x = (u - self.pp[0]) / self.focal * z
        y = (v - self.pp[1]) / self.focal * z
        return torch.stack(torch.broadcast_tensors(x, y, z), dim=-1)

    def depth_to_disp(self, depth):
        """The consistent inverse of unmap: d = f*b/z."""
        return self._fb() / depth

    def Q(self, device=None) -> torch.Tensor:
        """Reprojection matrix, float32: Q @ (u, v, d, 1) ~ (x, y, z, 1) up
        to scale."""
        f, (px, py) = self.focal, self.pp
        inv_b = _f32(np.float32(1.0) / np.float32(self.baseline))
        return torch.tensor([[1.0, 0.0, 0.0, -px], [0.0, 1.0, 0.0, -py],
                             [0.0, 0.0, 0.0, f], [0.0, 0.0, inv_b, 0.0]],
                            dtype=torch.float32, device=device)

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

"""Carry SLAM state across from numpy arrays.

A SLAM system has no weights: its state is the pose and point tables, the
camera, the rolling dense-tracking state (per-level clouds, intensities,
valid masks and template Jacobians) and the host bookkeeping of the
frontend. These functions build the port's objects from that state given as
numpy arrays — the form a test gets from the JAX package with ``np.asarray``
— so both frameworks can be put in the same state and stepped side by side.
"""

from __future__ import annotations

import numpy as np
import torch

from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.models.map_store import PointTable, PoseTable


def tensor(x, device=None, dtype=None) -> torch.Tensor:
    """numpy (or anything np.asarray takes) -> tensor on `device`."""
    return torch.as_tensor(np.array(x, copy=True), dtype=dtype, device=device)


def camera(focal, pp, size, baseline) -> StereoCamera:
    """StereoCamera from scalars (f32-rounded, as the JAX camera holds them)."""
    return StereoCamera.create(float(np.asarray(focal)), np.asarray(pp),
                               (int(size[0]), int(size[1])),
                               float(np.asarray(baseline)))


def pose_table(R, t, valid, device=None) -> PoseTable:
    """PoseTable from (K, 3, 3) R, (K, 3) t, (K,) valid."""
    return PoseTable(tensor(R, device, torch.float32),
                     tensor(t, device, torch.float32),
                     tensor(valid, device, torch.bool))


def point_table(psi, anchor, level, patch, uv0, valid, device=None) -> PointTable:
    """PointTable from the twin's fields (map_store.PointTable)."""
    return PointTable(tensor(psi, device, torch.float32),
                      tensor(anchor, device, torch.int32),
                      tensor(level, device, torch.int32),
                      tensor(patch, device, torch.float32),
                      tensor(uv0, device, torch.float32),
                      tensor(valid, device, torch.bool))


def dense_state(clouds, intens, valids, J, device=None):
    """Per-level rolling dense state: tuples (clouds, intens, valids, J)."""
    return (tuple(tensor(c, device, torch.float32) for c in clouds),
            tuple(tensor(i, device, torch.float32) for i in intens),
            tuple(tensor(v, device, torch.bool) for v in valids),
            tuple(tensor(j, device, torch.float32) for j in J))


def load_frontend_state(fe, *, poses, points, dense, R_cw, t_cw, R_cak, t_cak,
                        actkey_id, next_kf, next_point, kf_point_ids, covis,
                        pose_np, meta_anchor, meta_level, frame_id):
    """Put a port StereoFrontend into a given state: device tables (`poses`,
    `points` as PoseTable/PointTable), the dense state tuple from
    :func:`dense_state`, the world / actkey-relative pose, and the host
    bookkeeping (ids, covisibility, keyframe poses, point metadata)."""
    fe.poses = poses
    fe.points = points
    (fe._prev_clouds, fe._prev_intens, fe._prev_valids, fe._prev_J) = dense
    fe._R_cw = np.asarray(R_cw, np.float32).copy()
    fe._t_cw = np.asarray(t_cw, np.float32).copy()
    fe._R_cak = np.asarray(R_cak, np.float32).copy()
    fe._t_cak = np.asarray(t_cak, np.float32).copy()
    fe._dev_R_cw = None
    fe._dev_t_cw = None
    fe.actkey_id = int(actkey_id)
    fe.next_kf = int(next_kf)
    fe.next_point = int(next_point)
    fe.kf_point_ids = {int(k): np.asarray(v, np.int64).copy()
                       for k, v in kf_point_ids.items()}
    fe.covis = {int(k): {int(a): int(c) for a, c in v.items()}
                for k, v in covis.items()}
    fe.pose_np = {int(k): (np.asarray(v[0], np.float32).copy(),
                           np.asarray(v[1], np.float32).copy())
                  for k, v in pose_np.items()}
    fe._meta_anchor = np.asarray(meta_anchor, np.int64).copy()
    fe._meta_level = np.asarray(meta_level, np.int64).copy()
    fe.frame_id = int(frame_id)
    fe._cand_np = None
    return fe

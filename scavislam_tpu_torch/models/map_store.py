"""Device-resident map tables: keyframe poses + anchored points (port of
scavislam_tpu.models.map_store).

Two fixed-capacity structure-of-arrays tables on the device:
- pose table: (K, 3, 3) rotations + (K, 3) translations + valid mask
  (T_kw = world->keyframe), K = MAX_KEYFRAMES;
- point table: (P, 3) inverse-depth psi = (x/z, y/z, 1/z) in the ANCHOR
  frame, (P,) anchor keyframe index, (P,) pyramid level, (P, 16, 16) source
  patches, (P, 2) creation pixel, valid mask.

Updates are functional, as in the twin: ``set`` and ``insert_block`` return
new tables and leave the old ones intact, so a table handed out as a
snapshot (``AddToOptimizer.points_snapshot``) never changes under its
holder. Only the fields a write touches are copied.

The padded scatters (``PoseTable.set_many``, ``scatter_psi``) drop indices
outside ``[0, cap)``, as the twin's ``mode="drop"`` scatters do: callers pad
with the sentinel ``1 << 30``. The rows are masked out before the write, never
clamped (a clamped index would overwrite the last row; an unmasked one is a
device-side assert on CUDA).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scavislam_tpu_torch.core.lie import SE3

MAX_KEYFRAMES = 512
MAX_POINTS = 16384


class PoseTable(NamedTuple):
    R: torch.Tensor  # (K, 3, 3)
    t: torch.Tensor  # (K, 3)
    valid: torch.Tensor  # (K,)

    @staticmethod
    def empty(cap: int = MAX_KEYFRAMES, device=None) -> "PoseTable":
        return PoseTable(
            torch.eye(3, dtype=torch.float32, device=device)
            .expand(cap, 3, 3).clone(),
            torch.zeros((cap, 3), dtype=torch.float32, device=device),
            torch.zeros((cap,), dtype=torch.bool, device=device),
        )

    def set(self, idx: int, T_kw: SE3) -> "PoseTable":
        R, t, valid = self.R.clone(), self.t.clone(), self.valid.clone()
        R[idx] = torch.as_tensor(T_kw.R, dtype=torch.float32, device=R.device)
        t[idx] = torch.as_tensor(T_kw.t, dtype=torch.float32, device=t.device)
        valid[idx] = True
        return PoseTable(R, t, valid)

    def set_many(self, idx, Rs, ts) -> "PoseTable":
        """Batched pose writeback; out-of-range ids (padding) are dropped."""
        return _pose_scatter(self, idx, Rs, ts)


class PointTable(NamedTuple):
    psi: torch.Tensor  # (P, 3) inverse-depth in anchor frame
    anchor: torch.Tensor  # (P,) int32 keyframe index
    level: torch.Tensor  # (P,) int32 pyramid level
    patch: torch.Tensor  # (P, 16, 16) source patch (anchor level-l image)
    uv0: torch.Tensor  # (P, 2) creation pixel position, level-0 coords
    valid: torch.Tensor  # (P,)

    @staticmethod
    def empty(cap: int = MAX_POINTS, device=None) -> "PointTable":
        f32 = torch.float32
        return PointTable(
            torch.zeros((cap, 3), dtype=f32, device=device),
            torch.zeros((cap,), dtype=torch.int32, device=device),
            torch.zeros((cap,), dtype=torch.int32, device=device),
            torch.zeros((cap, 16, 16), dtype=f32, device=device),
            torch.zeros((cap, 2), dtype=f32, device=device),
            torch.zeros((cap,), dtype=torch.bool, device=device),
        )

    def insert_block(self, start: int, psi, anchor_id: int, level, patches,
                     uv0, ok) -> "PointTable":
        """Write a contiguous block of new points starting at `start`. The
        start is clamped so the block fits, as jax.lax.dynamic_update_slice
        clamps it."""
        n = psi.shape[0]
        cap = self.psi.shape[0]
        s = max(0, min(int(start), cap - n))
        sl = slice(s, s + n)

        def put(table, block):
            out = table.clone()
            out[sl] = block.to(out.dtype)
            return out

        anchor = torch.full((n,), int(anchor_id), dtype=torch.int32,
                            device=self.anchor.device)
        return PointTable(
            put(self.psi, psi), put(self.anchor, anchor),
            put(self.level, level), put(self.patch, patches),
            put(self.uv0, uv0), put(self.valid, ok),
        )


def _masked_put(table: torch.Tensor, idx, vals) -> torch.Tensor:
    """A copy of `table` with rows `idx` set to `vals`, rows whose index lies
    outside [0, cap) dropped. The dropped rows are sent to one spare row past
    the end, which is cut off again: no host sync, no real row touched."""
    cap = table.shape[0]
    idx = idx.to(device=table.device, dtype=torch.int64)
    idx = torch.where((idx >= 0) & (idx < cap), idx, torch.full_like(idx, cap))
    out = torch.cat([table, table[:1]])
    out.index_put_((idx,), vals.to(device=table.device, dtype=table.dtype)
                   .expand(idx.shape[0], *table.shape[1:]))
    return out[:cap]


def _pose_scatter(poses: PoseTable, idx, Rs, ts) -> PoseTable:
    return PoseTable(
        _masked_put(poses.R, idx, Rs),
        _masked_put(poses.t, idx, ts),
        _masked_put(poses.valid, idx,
                    torch.ones((), dtype=torch.bool, device=poses.R.device)),
    )


def scatter_psi(psi_table: torch.Tensor, pids, vals) -> torch.Tensor:
    """Masked psi writeback: `pids` padded with out-of-range ids (dropped).

    The backend returns a different number of optimized points per
    neighborhood; callers pad to a fixed capacity."""
    return _masked_put(psi_table, pids, vals)


def materialize_points(poses: PoseTable, points: PointTable, ids: torch.Tensor):
    """Gather world positions + anchor poses for point ids (N,).

    xyz_w = A_aw^-1 * invert_depth(psi). Returns
    (xyz_w (N,3), R_aw (N,3,3), t_aw (N,3), patches (N,16,16), ok (N,)).
    Invalid ids (< 0) yield ok=False.
    """
    ids = ids.to(torch.int64)
    safe = ids.clamp(0, points.psi.shape[0] - 1)
    psi = points.psi[safe]
    q = psi[:, 2:3]
    q_safe = torch.where(torch.abs(q) < 1e-9, torch.full_like(q, 1e-9), q)
    xyz_a = torch.cat([psi[:, :2], torch.ones_like(q)], dim=-1) / q_safe
    a_idx = points.anchor[safe].to(torch.int64)
    R_aw = poses.R[a_idx]
    t_aw = poses.t[a_idx]
    # T_wa = T_aw^-1 : x_w = R_aw^T (x_a - t_aw)
    xyz_w = torch.einsum("nji,nj->ni", R_aw, xyz_a - t_aw)
    ok = (ids >= 0) & points.valid[safe] & poses.valid[a_idx] & (q[:, 0] > 1e-9)
    return xyz_w, R_aw, t_aw, points.patch[safe], ok

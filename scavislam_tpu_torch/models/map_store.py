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

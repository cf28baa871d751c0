"""StreamPool: N live visual-odometry streams through ONE batched step per
tick (port of scavislam_tpu.parallel.stream_pool).

N independent camera streams, each with its own keyframe map, covisibility
graph, candidate set and trajectory, share the batched frontend step
(parallel.multistream.build_multistream_frontend) and one packed fetch per
tick.

Division of labour per tick (B streams, one frame each):
  host:   per-stream candidate assembly (numpy)   -> ONE (B, C) upload
          (only when some stream's candidates changed)
          the B frames                            -> ONE (B, 2, H, W) uint8
                                                     upload (none when the
                                                     frames are on the card)
  device: ONE batched step (all B streams; on a card ONE CUDA graph
          replay of the batched block-matching call
          and the vmapped step)                   -> chained pose state
  host:   ONE (B, K) packed fetch, consumed `pipeline_depth` ticks later:
          per-stream keyframe policy on each row; a stream that decides a
          keyframe dispatches its own spawn step against its OWN tables,
          and the batched tables are restacked at the next tick (only
          then: the step's graph copies a table only when it is a new
          tensor, as it copies the active keyframes only when one moved).

With a mesh (parallel/mesh.py) the batched step splits the B streams over
the mesh's "dp" axis: each shard's B / dp streams run on its device, one
graph replay (one batched block-matching call) per shard, and the outputs
come back to the mesh's first device, where the pool's state lives.

Each stream's host state is a full StereoFrontend: policy, spawn, epoch
guard, covisibility and id bookkeeping are the same code as its pipelined
mode; only the device step and the packed fetch are batched here. Streams
fail independently: a tracking loss marks the stream dead, and the batch
keeps running (its row computes garbage that nobody reads).
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from scavislam_tpu_torch import resolve_device
from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.models.frontend import (
    CAND_CAP,
    StereoFrontend,
    _to_u8,
)
from scavislam_tpu_torch.models.frontend_step import DENSE_SUBS_BATCHED
from scavislam_tpu_torch.models.host_frontend import Fetch, InFlight, _upload
from scavislam_tpu_torch.parallel.multistream import (
    build_multistream_frontend,
    stack_streams,
)
from scavislam_tpu_torch.utils.config import Config
from scavislam_tpu_torch.utils.perfmon import Spans, span_s


class _StreamView:
    """Lazy single-stream view of a batched FrontendStepOut: a leaf is
    sliced when the per-stream policy touches it (pyr/disp for keyframe
    spawns, cached)."""

    def __init__(self, out, s: int):
        self._out = out
        self._s = s
        self._cache = {}

    @property
    def pyr(self):
        if "pyr" not in self._cache:
            self._cache["pyr"] = tuple(p[self._s] for p in self._out.pyr)
        return self._cache["pyr"]

    @property
    def disp(self):
        if "disp" not in self._cache:
            self._cache["disp"] = self._out.disp[self._s]
        return self._cache["disp"]

    def __getattr__(self, name):
        leaf = getattr(self._out, name)
        if isinstance(leaf, tuple):
            return tuple(x[self._s] for x in leaf)
        return leaf[self._s]


class StreamPool:
    """N concurrent visual-odometry streams over one batched device step.

    Keyframe spawning, candidate matching, switch policy and the epoch guard
    run per stream (each stream owns a StereoFrontend); the per-frame
    compute and the host<->device traffic are batched: one frame upload,
    one step, one packed fetch per tick for ALL streams. With a `mesh`,
    the streams are split over its "dp" axis and the pool runs on the
    mesh's first device (`device` is then unused)."""

    def __init__(self, cam: StereoCamera, cfg: Config = None,
                 n_streams: int = 8, mesh=None, pipeline_depth: int = 2,
                 device=None):
        self.cfg = cfg or Config()
        self.B = int(n_streams)
        self.mesh = mesh
        if mesh is not None:
            dp = mesh.shape["dp"]
            if self.B % dp:
                raise ValueError(
                    f"n_streams={n_streams} not divisible by mesh dp={dp}")
        self.device = (mesh.first if mesh is not None
                       else resolve_device(device))
        self.fes = [StereoFrontend(cam, self.cfg, device=self.device)
                    for _ in range(self.B)]
        # host spans and synchronizing calls of the pool and its streams
        self.spans = Spans(self)
        # pool streams track at the reference's own CPU density (every 4th
        # pixel at levels 0-1); the rolled state must match the step's
        for fe in self.fes:
            fe.dense_subs = DENSE_SUBS_BATCHED
            fe.spans = self.spans
        fe0 = self.fes[0]
        self.step = build_multistream_frontend(
            mesh, fe0._cam_params, fe0._cam_statics, levels=fe0.levels,
            num_disp=fe0._num_disp,
            max_reproj=float(self.cfg.ui.max_reproj_error),
            dense_subs=DENSE_SUBS_BATCHED,
        )
        self.trajectories = [[] for _ in range(self.B)]
        self.alive = [True] * self.B
        self.pipeline_depth = int(pipeline_depth)
        # when set to a list, process_frames appends one (dispatch_s,
        # fetch_wait_s, consume_s, folded) tuple per tick: the seconds of
        # the tick's pool.dispatch, its pool.fetch_wait and the rest of its
        # pool.consume, and what `spans` recorded since the previous entry
        # (perfmon.Spans.fold; the streams' frontend.* spans summed by
        # name), with "streams": each stream's frontend.consume seconds
        self.timing_log = None
        self._pending = deque()
        # batched device state
        self._prev = None  # (clouds, intens, valids, Js), leading B axis
        self._chain = None  # (R_cw (B,3,3), t_cw (B,3)) device pose chain
        self._tables_key = None
        self._poses_b = None
        self._points_b = None
        self._cand_np = None
        self._cand_dev = None
        self._actkey = None  # (host list, (B,) int32 device tensor)

    # ------------------------------------------------------------------ #
    def _restack_tables(self):
        """Restack the per-stream device tables into the batched tables
        when some stream's tables_version moved (a keyframe spawn); most
        ticks this is a cache hit."""
        key = tuple(fe.tables_version for fe in self.fes)
        if key != self._tables_key:
            self._poses_b = stack_streams([fe.poses for fe in self.fes])
            self._points_b = stack_streams([fe.points for fe in self.fes])
            self._tables_key = key
        return self._poses_b, self._points_b

    def _cand_device(self, cand_rows: np.ndarray):
        if self._cand_np is None or not np.array_equal(
                self._cand_np, cand_rows):
            self._cand_np = cand_rows.copy()
            self._cand_dev = _upload(cand_rows.astype(np.int32),
                                     self.device)
        return self._cand_dev

    def _actkey_device(self):
        """The streams' active keyframes as one (B,) int32 device tensor,
        uploaded only when one of them moved (the step's graph then
        copies it; most ticks it is the tensor copied last time)."""
        ak = [max(fe.actkey_id, 0) for fe in self.fes]
        if self._actkey is None or self._actkey[0] != ak:
            self._actkey = (ak, _upload(np.asarray(ak, np.int32),
                                        self.device))
        return self._actkey[1]

    def _upload_frames(self, frames):
        """The tick's frames as ONE (B, 2, H, W) uint8 tensor on the pool's
        device: host frames stacked on the host and uploaded once, device
        frames stacked in place."""
        if isinstance(frames[0]["left"], torch.Tensor):
            return torch.stack([
                torch.stack([_to_u8(f["left"]), _to_u8(f["right"])])
                for f in frames]).to(self.device)
        stacked = np.stack([
            np.stack([_to_u8(np.asarray(f["left"])),
                      _to_u8(np.asarray(f["right"]))])
            for f in frames])
        return _upload(stacked, self.device)

    def _dispatch(self, frames, cand_rows):
        with self.spans.span("pool.inputs"):
            poses_b, points_b = self._restack_tables()
            args = (self._upload_frames(frames), *self._prev,
                    self._chain[0], self._chain[1],
                    self._actkey_device(), poses_b, points_b,
                    self._cand_device(cand_rows))
        with self.spans.span("step.launch"):
            out = self.step(*args)
        self._chain = (out.R_cw, out.t_cw)
        self._prev = (out.clouds, out.intens, out.cloud_valids, out.cloud_J)
        return out

    # ------------------------------------------------------------------ #
    def process_first_frames(self, frames: list):
        """Frame 0 of every stream: each becomes its stream's first keyframe
        at the origin (parity per stream: processFirstFrame,
        stereo_frontend.cpp:91-181)."""
        if len(frames) != self.B:
            raise ValueError(f"{len(frames)} frames for {self.B} streams")
        h, w = tuple(frames[0]["left"].shape)
        empty = self.fes[0]._empty_prev_state((h, w))
        self._prev = tuple(tuple(x.expand(self.B, *x.shape) for x in e)
                           for e in empty)
        self._chain = (
            torch.eye(3, dtype=torch.float32, device=self.device)
            .expand(self.B, 3, 3),
            torch.zeros((self.B, 3), dtype=torch.float32, device=self.device),
        )
        cand_rows = np.full((self.B, CAND_CAP), -1, np.int64)
        out = self._dispatch(frames, cand_rows)
        pkts = []
        for s, fe in enumerate(self.fes):
            pkts.append(fe.bootstrap_first(_StreamView(out, s), frames[s]))
            self.trajectories[s].append(
                (frames[s].get("frame_id", 0), fe._world_pose()))
        return pkts

    def process_frames(self, frames: list):
        """One pool tick: dispatch this batch of frames (one per stream),
        then consume the batch dispatched `pipeline_depth` ticks ago.
        Returns None while the pipeline fills, else the consumed tick's
        per-stream (success, dropped, frame_id) list."""
        if len(frames) != self.B:
            raise ValueError(f"{len(frames)} frames for {self.B} streams")
        with self.spans.span("pool.dispatch"):
            with self.spans.span("pool.candidates"):
                cand_rows = np.stack([fe._collect_candidates()
                                      for fe in self.fes])
            out = self._dispatch(frames, cand_rows)
            self._pending.append((
                [f.get("frame_id") for f in frames], cand_rows, out,
                Fetch(out.packed), [fe._kf_epoch for fe in self.fes],
            ))
        if len(self._pending) <= max(1, self.pipeline_depth):
            self._log_entry([0.0] * self.B)
            return None
        with self.spans.span("pool.consume"):
            results, stream_s = self._consume_oldest()
        self._log_entry(stream_s)
        return results

    def _log_entry(self, stream_s):
        """Append the tick's timing_log entry (when there is a log)."""
        if self.timing_log is None:
            return
        f = self.spans.fold()
        f["streams"] = stream_s
        wait = span_s(f, "pool.fetch_wait")
        self.timing_log.append((span_s(f, "pool.dispatch"), wait,
                                span_s(f, "pool.consume") - wait, f))

    def _consume_oldest(self):
        """The oldest tick's policy: (per-stream results, each stream's
        frontend.consume seconds, 0 where not recorded)."""
        fids, cand_rows, out, fut, epochs = self._pending.popleft()
        if not fut.done():
            self.spans.sync("tick.fetch")
        with self.spans.span("pool.fetch_wait"):
            pk = fut.result()  # (B, K): the ONE packed fetch for all streams
        results, stream_s = [], [0.0] * self.B
        for s, fe in enumerate(self.fes):
            if not self.alive[s]:
                results.append((False, False, fids[s]))
                continue
            # the stream's row of the landed fetch (a host Fetch, landed)
            ok, dropped = fe._consume(InFlight(
                fids[s], cand_rows[s], _StreamView(out, s),
                Fetch(torch.from_numpy(pk[s])), epochs[s], None))
            if self.timing_log is not None:
                stream_s[s] = self.spans.last_s
            if ok:
                self.trajectories[s].append((fids[s], fe._world_pose()))
            else:
                self.alive[s] = False
            results.append((ok, dropped, fids[s]))
        return results, stream_s

    def finish(self):
        """Drain the pipeline and finalize any pending keyframe spawns."""
        results = []
        while self._pending:
            results.append(self._consume_oldest()[0])
        for fe in self.fes:
            fe._finalize_pending_spawn()
        return results

    def take_ready_packets(self):
        """Per-stream finalized AddToOptimizer packets since the last call:
        list of (stream_idx, packet)."""
        out = []
        for s, fe in enumerate(self.fes):
            for pkt in fe.take_ready_packets():
                out.append((s, pkt))
        return out

    def keyframe_counts(self):
        return [fe.next_kf for fe in self.fes]

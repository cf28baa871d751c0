"""Monocular SLAM: the frame loop around ``MonoFrontend`` with window BA,
Sim3 loop closure and relocalization, the mono mode's system entry (the
monocular counterpart of ``pipeline.slam_system.SlamSystem``).

Per frame, on the caller's thread:
  1. the first frame makes keyframe 0 (and indexes it for place
     recognition);
  2. later frames run the frame step, synchronously or pipelined (the
     policy ``pipeline_depth`` frames behind the dispatch);
  3. at each new keyframe: the window BA (the last-K window or, with
     ``dwo``, the covisibility double window; dispatched and adopted at a
     later frame when pipelined, solved inline otherwise), then the
     keyframe is indexed and, where retrieval and the Sim3 verification
     fire, the loop is closed by the Sim3 pose graph
     (``models.mono_loop``);
  4. a tracking failure with loop closure on puts the system in ``lost``
     mode: each later frame is queried against the keyframe index until
     one relocalizes. Without loop closure a failure ends tracking.

``finish()`` flushes the pipeline (running the keyframe hooks of the
frames it consumes) and adopts a window solve still in flight.

The place work and the relocalization attempts are host spans of the
frontend's ``spans`` (``mono.place``, ``mono.relocalize``), on while its
``timing_log`` is a list.

Frames are dicts as ``MonoFrontend`` takes them: ``left`` (the image),
or the image on the device as ``left_dev``, or as plane 0 of
``stacked_dev``. The place recognizer reads the f32 level-0 image: a
frame without ``left`` gives it its device plane, normalized as the frame
step normalizes it.
"""

from __future__ import annotations

import sys

from scavislam_tpu_torch.models import mono_loop
from scavislam_tpu_torch.models.frontend_step import normalize_frames
from scavislam_tpu_torch.models.mono_frontend import MonoFrontend


class MonoSystem:
    def __init__(self, cam, cfg=None, *, prior_idepth: float = 0.25,
                 pipelined: bool = False, pipeline_depth: int = None,
                 window_ba: bool = False, dwo: bool = False,
                 dwo_inner: int = 5, dwo_outer: int = 16,
                 loop_close: bool = False, vocabulary=None,
                 loop_score_thr: float = None, frontend: MonoFrontend = None,
                 device=None):
        """`frontend` runs a given frontend (a restored one, or one with
        other filter settings) instead of a new one; `vocabulary` (None:
        the shipped one) and `loop_score_thr` (None: the reference's 2.0)
        are the place recognizer's."""
        self.frontend = frontend if frontend is not None else MonoFrontend(
            cam, cfg, prior_idepth=prior_idepth, device=device)
        if pipeline_depth:
            self.frontend.pipeline_depth = pipeline_depth
        self.pipelined = pipelined
        self.window_ba = window_ba
        self.dwo = dwo
        self.dwo_inner = dwo_inner
        self.dwo_outer = dwo_outer
        self.place_recognizer = (
            mono_loop.make_mono_place_recognizer(
                self.frontend, vocabulary, score_thr=loop_score_thr)
            if loop_close else None)
        self.loops_closed: list[dict] = []
        self.lost = False
        self.relocalizations = 0
        self.frames = 0  # frames handed in

    @property
    def trajectory(self) -> list:
        """[(frame_id, PoseRT T_cw)] of every tracked frame."""
        return self.frontend.trajectory

    def _left(self, frame):
        """The frame's image as the place recognizer reads it."""
        if "left" in frame:
            return frame["left"]
        return normalize_frames(self.frontend._image_dev(frame))

    def _index_keyframe(self, kf_id: int, img):
        fe = self.frontend
        with fe.spans.span("mono.place"):
            det = mono_loop.add_keyframe_to_recognizer(
                self.place_recognizer, fe, kf_id, img)
            if det is None:
                return
            scales = mono_loop.close_loop_sim3(
                fe, det.query_id, det.loop_id, det.S_query_from_loop)
        self.loops_closed.append({
            "query": det.query_id, "loop": det.loop_id,
            "inliers": det.inliers,
            "scale": round(float(det.S_query_from_loop.s), 4),
            "regauge": round(scales[det.query_id], 4),
        })

    def _on_keyframe(self, kf_id: int, img):
        fe = self.frontend
        if self.window_ba:
            # pipelined runs dispatch the solve and adopt it at a later
            # frame; synchronous runs solve inline
            fe.window_ba(window=self.dwo_inner if self.dwo else 5,
                         sync=not self.pipelined, dwo=self.dwo,
                         outer=self.dwo_outer)
        if self.place_recognizer is not None:
            self._index_keyframe(kf_id, img)

    def process_first_frame(self, frame: dict):
        """Keyframe 0 from the first frame (indexed for recognition)."""
        fe = self.frontend
        self.frames += 1
        fe.process_first_frame(frame)
        if self.place_recognizer is not None:
            self._index_keyframe(fe.actkey_id, self._left(frame))

    def process_frame(self, frame: dict) -> bool:
        """Track one frame (or, in lost mode, try to relocalize on it).
        Returns False when tracking failed with no place recognizer to
        recover by: the system takes no more frames then."""
        fe = self.frontend
        n = self.frames
        self.frames += 1
        if self.lost:
            if self.place_recognizer is not None:
                if "left" not in frame:
                    frame = dict(frame, left=self._left(frame))
                with fe.spans.span("mono.relocalize"):
                    ok = fe.relocalize(self.place_recognizer, frame)
                if ok:
                    self.lost = False
                    self.relocalizations += 1
            return True
        if self.pipelined:
            r = fe.process_frame_pipelined(frame)
            if r is None:
                return True
            ok, dropped, _fid = r
            where = "near frame"
        else:
            ok, dropped = fe.process_frame(frame)
            where = "at frame"
        if not ok:
            if self.place_recognizer is not None:
                # lost mode: keep consuming frames and relocalize
                print(f"mono tracking lost {where} {n}; relocalizing",
                      file=sys.stderr)
                self.lost = True
                return True
            print(f"mono tracking FAILED {where} {n}", file=sys.stderr)
            return False
        if dropped:
            self._on_keyframe(fe.actkey_id, fe.last_kf_img if self.pipelined
                              else self._left(frame))
        return True

    def finish(self):
        """End of the sequence: consume the frames in flight (with their
        keyframe hooks) and adopt a window solve still in flight, so that
        the trajectory and the map reflect it."""
        fe = self.frontend
        if not self.pipelined:
            return
        for _ok, dropped, _fid in fe.flush_pipeline():
            if dropped:
                self._on_keyframe(fe.actkey_id, fe.last_kf_img)
        fe.adopt_pending_ba(force=True)

"""MonoSystem (pipeline/mono_system.py), the monocular system entry that
apps/mono_vo and the benchmark both run, against the frame loop mono_vo
ran inline before it (a copy kept here), and MonoFrontend's host spans
and synchronizing-call counts.

Frames: the port's renderer on the CPU at the twin's 128x96 test camera,
the forward arc at the mono tests' step; a parallax threshold of 0.12
drops a keyframe every few frames, so that the window BA, its double
window, place recognition and the pipelined adoption all run. A longer
run of the same arc holds the pipelined adoptions' rebases on SO(3).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.io.synthetic import SyntheticSequence
from scavislam_tpu_torch.models import mono_loop
from scavislam_tpu_torch.models.mono_frontend import MonoFrontend
from scavislam_tpu_torch.models.mono_step import mono_step
from scavislam_tpu_torch.pipeline.mono_system import MonoSystem
from scavislam_tpu_torch.utils import perfmon
from scavislam_tpu_torch.utils.config import Config

CAM = StereoCamera.create(130.0, (63.5, 47.5), (128, 96), 0.12)
N = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    cfg = Config()
    return dataclasses.replace(cfg, ui=dataclasses.replace(
        cfg.ui, parallax_thr=0.12))


@functools.lru_cache(maxsize=None)
def _frames():
    seq = SyntheticSequence(CAM, n_frames=N, kind="forward_arc", step=0.035,
                            device="cpu")
    return tuple(seq.frame(i) for i in range(N))


def frames():
    return [dict(f) for f in _frames()]


# frames of the arc for the adoption chain: the unprojected rebases lost
# the first frame after a spawn near frame 56 (pipelined, depth 3)
N_LONG = 60


@functools.lru_cache(maxsize=None)
def _long_frames():
    seq = SyntheticSequence(CAM, n_frames=N_LONG, kind="forward_arc",
                            step=0.035, device="cpu")
    return tuple(seq.frame(i) for i in range(N_LONG))


def old_loop(fe, detector, pipelined, window=True, dwo=True, inner=5,
             outer=16):
    """The per-frame loop of apps/mono_vo.main before MonoSystem, as it
    was (the viewers and the summary left out)."""
    loops_closed = []

    def on_keyframe(kf_id, img):
        if window:
            fe.window_ba(window=inner if dwo else 5, sync=not pipelined,
                         dwo=dwo, outer=outer)
        if detector is not None:
            index_keyframe(kf_id, img)

    def index_keyframe(kf_id, img):
        det = mono_loop.add_keyframe_to_recognizer(detector, fe, kf_id, img)
        if det is not None:
            scales = mono_loop.close_loop_sim3(
                fe, det.query_id, det.loop_id, det.S_query_from_loop)
            loops_closed.append({
                "query": det.query_id, "loop": det.loop_id,
                "inliers": det.inliers,
                "scale": round(float(det.S_query_from_loop.s), 4),
                "regauge": round(scales[det.query_id], 4),
            })

    n = 0
    lost = False
    relocs = 0
    for frame in frames():
        if n == 0:
            fe.process_first_frame(frame)
            if detector is not None:
                index_keyframe(fe.actkey_id, frame["left"])
        elif lost:
            if detector is not None and fe.relocalize(detector, frame):
                lost = False
                relocs += 1
        elif pipelined:
            r = fe.process_frame_pipelined(frame)
            if r is not None:
                ok, dropped, _fid = r
                if not ok:
                    if detector is not None:
                        lost = True
                        n += 1
                        continue
                    break
                if dropped:
                    on_keyframe(fe.actkey_id, fe.last_kf_img)
        else:
            ok, dropped = fe.process_frame(frame)
            if not ok:
                if detector is not None:
                    lost = True
                    n += 1
                    continue
                break
            if dropped:
                on_keyframe(fe.actkey_id, frame["left"])
        n += 1
    if pipelined:
        for ok, dropped, _fid in fe.flush_pipeline():
            if dropped:
                on_keyframe(fe.actkey_id, fe.last_kf_img)
        fe.adopt_pending_ba(force=True)
    return loops_closed, relocs


def run_system(pipelined, **kw):
    s = MonoSystem(CAM, _cfg(), pipelined=pipelined, pipeline_depth=3,
                   window_ba=True, dwo=True, loop_close=True, device="cpu",
                   **kw)
    fs = frames()
    s.process_first_frame(fs[0])
    for f in fs[1:]:
        assert s.process_frame(f)
    s.finish()
    return s


@pytest.mark.parametrize("pipelined", [True, False],
                         ids=["pipelined", "sync"])
def test_system_equals_the_old_mono_vo_loop(pipelined):
    fe = MonoFrontend(CAM, _cfg(), device="cpu")
    fe.pipeline_depth = 3
    detector = mono_loop.make_mono_place_recognizer(fe)
    loops, relocs = old_loop(fe, detector, pipelined)
    s = run_system(pipelined)
    got = s.frontend
    assert got.next_kf == fe.next_kf and fe.next_kf >= 3
    assert [f for f, _ in got.trajectory] == [f for f, _ in fe.trajectory]
    for (_, a), (_, b) in zip(got.trajectory, fe.trajectory):
        assert np.array_equal(a.R, b.R) and np.array_equal(a.t, b.t)
    assert sorted(got.pose_np) == sorted(fe.pose_np)
    for k, (R, t) in fe.pose_np.items():
        assert np.array_equal(got.pose_np[k][0], R)
        assert np.array_equal(got.pose_np[k][1], t)
    assert got.covis == fe.covis
    assert torch.equal(got.points.psi, fe.points.psi)
    assert s.loops_closed == loops and s.relocalizations == relocs
    assert (s.place_recognizer.counters["indexed"]
            == detector.counters["indexed"] == fe.next_kf)


def test_cpu_steps_eagerly():
    # the CUDA graph exists only on a card: on the CPU the frame step is
    # mono_step itself
    assert MonoFrontend(CAM, _cfg(), device="cpu")._step is mono_step


def test_pipelined_adoptions_keep_every_pose_on_so3():
    # 60 frames pipelined at depth 3 with the double-window BA: a keyframe
    # every few frames, and each one's window solve adopted while three
    # frames are in flight. Each adoption rebases the tracking chain and
    # the in-flight frames through the active keyframe's correction, f32
    # rotations composed on the host; unprojected, their non-orthonormality
    # roughly tripled at every adoption (the rebased chain seeds the next
    # keyframe, which the next rebase composes again) until the first
    # frame after a spawn lost its pose. Every frame keeps a pose, and
    # every keyframe's rotation and the chain's stay orthonormal to f32
    # rounding
    s = MonoSystem(CAM, _cfg(), pipelined=True, pipeline_depth=3,
                   window_ba=True, dwo=True, device="cpu")
    fs = [dict(f) for f in _long_frames()]
    s.process_first_frame(fs[0])
    for f in fs[1:]:
        assert s.process_frame(f), f["frame_id"]
    s.finish()
    fe = s.frontend
    assert [fid for fid, _ in fe.trajectory] == list(range(N_LONG))
    assert fe.next_kf >= 12  # many adoptions, each a rebase
    rots = [R for R, _ in fe.pose_np.values()] + [fe._R_cw]
    for R in rots:
        R = R.astype(np.float64)
        assert np.abs(R @ R.T - np.eye(3)).max() < 1e-5


def test_spans_are_off_without_a_log(monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock with timing_log None")

    monkeypatch.setattr(perfmon, "perf_counter", no_clock)
    s = MonoSystem(CAM, _cfg(), pipelined=True, pipeline_depth=3,
                   window_ba=True, dwo=True, loop_close=True, device="cpu")
    fs = frames()[:8]
    s.process_first_frame(fs[0])
    for f in fs[1:]:
        s.process_frame(f)
    s.finish()
    assert s.frontend.timing_log is None
    assert s.frontend.spans._done == []
    assert s.frontend.next_kf >= 2  # spawns and windows ran, unrecorded


def test_spans_are_recorded_per_frame():
    fe = MonoFrontend(CAM, _cfg(), device="cpu")
    s = MonoSystem(CAM, _cfg(), pipelined=True, pipeline_depth=3,
                   window_ba=True, dwo=True, loop_close=True, frontend=fe)
    fe.timing_log = []
    fs = frames()
    s.process_first_frame(fs[0])
    for f in fs[1:]:
        s.process_frame(f)
    assert len(fe.timing_log) == N - 1  # one entry a call that stepped
    s.finish()
    assert len(fe.timing_log) == N - 1 + 3  # and one a flushed frame
    for k, (fid, dispatch, wait, consume, folded) in enumerate(
            fe.timing_log):
        spans = folded["spans"]
        if k < N - 1:
            assert fid == (k + 1 if k < 3 else k - 2)
            assert spans["mono.dispatch"][2] == 1
            assert spans["mono.step"][2] == 1
            assert dispatch == spans["mono.dispatch"][0] > 0
            # the step inside the dispatch
            assert spans["mono.dispatch"][1] == pytest.approx(
                spans["mono.dispatch"][0] - spans["mono.step"][0])
        if k >= 3:  # a frame consumed
            assert spans["mono.consume"][2] == 1
            assert consume == pytest.approx(spans["mono.consume"][0] - wait)
        assert wait == 0.0  # a CPU fetch is never pending
    # a keyframe dropped by the flush's last frame: its window and place
    # spans are recorded after the last entry, for the next one
    rest = fe.spans.fold()
    every = {}
    for folded in [e[-1] for e in fe.timing_log] + [rest]:
        for name, (_, _, n) in folded["spans"].items():
            every[name] = every.get(name, 0) + n
    # every keyframe spawned and indexed, keyframe 0 too; a window BA at
    # each after it
    assert every["mono.spawn"] == every["mono.place"] == fe.next_kf
    assert every["mono.window_ba"] == fe.next_kf - 1
    assert every["mono.adopt"] >= 1


def test_syncs_are_counted_by_site():
    """On the CPU every upload counts at its site as on a card; a fetch
    never waits here, so no fetch site counts."""
    fe = MonoFrontend(CAM, _cfg(), device="cpu")
    s = MonoSystem(CAM, _cfg(), window_ba=True, dwo=True, loop_close=True,
                   frontend=fe)
    fs = frames()
    left = fs[0]["left"].numpy()  # a host image: its upload counts
    s.process_first_frame(dict(fs[0], left=left))
    assert dict(fe.spans.syncs) == {"frame.upload": 1, "keyframe.pose": 3,
                                    "spawn.upload": 3}
    fe.spans.syncs.clear()
    assert s.process_frame(fs[1])
    # the first step: its pose chain and its candidates go up as pinned
    # copies, which do not synchronize
    assert dict(fe.spans.syncs) == {}
    fe.spans.syncs.clear()
    k = 2
    while fe.next_kf == 1:
        assert s.process_frame(fs[k])
        k += 1
    # the keyframe: its pose and spawn, the synchronous window (assembly,
    # then write-back); its place query's download never waits here
    assert dict(fe.spans.syncs) == {
        "keyframe.pose": 3, "spawn.upload": 3, "window.upload": 18,
        "adopt.upload": 4}
    fe.spans.syncs.clear()
    assert s.process_frame(fs[k])
    # after the write-back: the chain and the new candidates go up again,
    # as pinned copies
    assert dict(fe.spans.syncs) == {}

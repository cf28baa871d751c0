"""The pipelined StereoFrontend (process_frame_pipelined / flush_pipeline)
against the JAX package's pipelined frontend on the same frames, on the CPU.

The pipelined policy reads whether a fetch has landed (`done()`): the
spawn-at-pipeline-head source and the deferred spawn's finalize. The port's
fetches complete at once on the CPU; the JAX side gets an executor that runs
inline and returns completed futures, so both sides are deterministic.
Both run stereo method 1 for the parity test (the JAX package runs that
twin on the CPU for methods 1 and 2 alike).
"""

import dataclasses
import warnings
from concurrent.futures import Future

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from scavislam_tpu.core.camera import StereoCamera as JCam
from scavislam_tpu.io.synthetic import SyntheticSequence
from scavislam_tpu.models.frontend import StereoFrontend as JFrontend
from scavislam_tpu.utils.config import Config as JConfig
from scavislam_tpu_torch import interop
from scavislam_tpu_torch.core.lie import PoseRT
from scavislam_tpu_torch.models.frontend import StereoFrontend as TFrontend
from scavislam_tpu_torch.utils import perfmon
from scavislam_tpu_torch.utils.config import Config as TConfig

J_CAM = JCam.create(195.0, (127.0, 95.0), (256, 192), 0.12)
T_CAM = interop.camera(np.asarray(J_CAM.focal), np.asarray(J_CAM.pp),
                       J_CAM.size, np.asarray(J_CAM.baseline))
N_FRAMES = 8
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the port issues thousands of small eager ops per
    frame, and with a test process per core torch's default of a thread per
    core in every process oversubscribes the machine (measured ~17x slower
    for two of these files in two processes on 8 cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _InlineExecutor:
    """submit() runs the call at once and returns a completed future."""

    def submit(self, fn, *args, **kwargs):
        fut = Future()
        fut.set_result(fn(*args, **kwargs))
        return fut


def _cfg(cls, method):
    # parallax_thr 0.1 (tests/test_parallel.py's pool test): keyframes are
    # decided mid-run, so the deferred spawn, the epoch guard and the
    # spawn-at-pipeline-head source all run
    cfg = cls()
    return dataclasses.replace(cfg, ui=dataclasses.replace(
        cfg.ui, stereo_method=method, parallax_thr=0.1))


@pytest.fixture(scope="module")
def frames():
    seq = SyntheticSequence(J_CAM, n_frames=N_FRAMES)
    return [{"frame_id": i, "left": np.array(f["left"]),
             "right": np.array(f["right"])}
            for i, f in enumerate(seq.frame(i) for i in range(N_FRAMES))]


def _position(T):
    R, t = np.asarray(T.R, np.float64), np.asarray(T.t, np.float64)
    return -R.T @ t


def _run_pipelined(fe, frames, traced=None):
    """process_first_frame, process_frame_pipelined, flush_pipeline: the
    consumed frame ids in order, each consumed frame's world pose, and the
    (frame id, keyframe id) of each packet that landed. With a set
    `traced`, the last frame runs under the profiler, and the set takes
    the names of its events."""
    fe.process_first_frame(frames[0])
    consumed, poses, packets = [0], {0: fe._world_pose()}, []
    for f in frames[1:]:
        if traced is not None and f is frames[-1]:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                r = fe.process_frame_pipelined(dict(f))
            traced.update(e.name for e in prof.events())
        else:
            r = fe.process_frame_pipelined(dict(f))
        if r is None:
            continue
        ok, dropped, fid = r
        assert ok, fid
        consumed.append(fid)
        poses[fid] = fe._world_pose()
        if dropped:
            packets.append((fid, fe.to_optimizer_stack[-1].kf_id))
    for ok, dropped, fid, pose, pkt in fe.flush_pipeline():
        assert ok, fid
        if fid is not None:
            consumed.append(fid)
            poses[fid] = pose
        if dropped:
            packets.append((fid, pkt.kf_id))
    return consumed, poses, packets


@pytest.fixture(scope="module")
def port_run(frames):
    """The port's pipelined run at method 1, with timing_log on and its
    last frame under the profiler: (frontend, consumed ids, poses,
    packets, the profiled frame's event names)."""
    ft = TFrontend(T_CAM, _cfg(TConfig, 1), device=CPU)
    ft.pipeline_depth = 2
    ft.timing_log = []
    traced = set()
    ct, pt, kt = _run_pipelined(ft, frames, traced)
    return ft, ct, pt, kt, traced


def test_pipelined_vo_matches_jax(frames, port_run):
    # depth 2 over the 8-frame forward arc: the same frames consumed, the
    # same keyframes (ids, count, the consume at which each packet landed),
    # camera positions within 1e-3 m frame by frame and keyframe positions
    # within 1e-3 m
    fj = JFrontend(J_CAM, _cfg(JConfig, 1))
    fj._fetch_pool = _InlineExecutor()
    fj.pipeline_depth = 2
    cj, pj, kj = _run_pipelined(fj, frames)
    ft, ct, pt, kt, _ = port_run
    assert ct == cj == list(range(N_FRAMES))
    assert kt == kj
    assert ft.next_kf == fj.next_kf >= 2  # a mid-run deferred spawn ran
    assert sorted(ft.keyframe_map) == sorted(fj.keyframe_map)
    assert [p.kf_id for p in ft.to_optimizer_stack] == \
        [p.kf_id for p in fj.to_optimizer_stack]
    for fid in ct:
        assert np.linalg.norm(_position(pt[fid]) - _position(pj[fid])) < 1e-3
    for k in fj.pose_np:
        Tj, Tt = PoseRT.from_any(fj.pose_np[k]), PoseRT.from_any(ft.pose_np[k])
        assert np.linalg.norm(_position(Tt) - _position(Tj)) < 1e-3, k


def test_pipelined_matches_sync(frames, monkeypatch):
    # the port's pipelined run tracks the same trajectory as its synchronous
    # run at the default stereo method (tests/test_frontend_vo.py:81-105:
    # every pose within 5e-3 in the SE3 log). Both run with timing_log
    # None: no span reads the clock or enters record_function, no entry
    clock_reads = []
    monkeypatch.setattr(perfmon, "perf_counter",
                        lambda: clock_reads.append(1) or 0.0)
    monkeypatch.setattr(perfmon, "record_function",
                        lambda name: clock_reads.append(name))
    sync = TFrontend(T_CAM, TConfig(), device=CPU)
    sync.process_first_frame(frames[0])
    ps = {0: sync._world_pose()}
    for f in frames[1:]:
        assert sync.process_frame(dict(f))[0]
        ps[f["frame_id"]] = sync._world_pose()
    pipe = TFrontend(T_CAM, TConfig(), device=CPU)
    _, pp, _ = _run_pipelined(pipe, frames)
    assert clock_reads == []
    assert sync.timing_log is None and pipe.timing_log is None
    # the counter counts with the switch off: a host frame's upload each
    assert sync.spans.syncs["frame.upload"] == N_FRAMES
    assert len(set(ps) & set(pp)) >= 6
    for fid in set(ps) & set(pp):
        d = (PoseRT.from_any(ps[fid]) @ PoseRT.from_any(pp[fid]).inverse()).log()
        assert float(d.abs().max()) < 5e-3, (fid, d)


def _assert_partition(folded, roots):
    """Each span within its parent (self time >= 0), and the roots' totals
    the sum of every span's self time."""
    spans = folded["spans"]
    for name, (total, own, n) in spans.items():
        assert n >= 1 and -1e-9 <= own <= total + 1e-9, name
    assert sum(own for _, own, _ in spans.values()) == pytest.approx(
        sum(spans[r][0] for r in roots if r in spans), rel=1e-9, abs=1e-12)


def test_frame_spans_partition_the_frame(port_run):
    ft, consumed, *_ = port_run
    log = ft.timing_log
    # one entry per process_frame_pipelined call, the dispatched frame's
    # while the pipeline fills, then the consumed frame's; none at the flush
    assert [x[0] for x in log] == [1, 2] + consumed[1:N_FRAMES - 2]
    for fid, dispatch, wait, consume, f in log[1:]:
        sp = f["spans"]
        assert set(sp) <= {"frontend.neighborhood", "frontend.dispatch",
                           "frontend.candidates", "frontend.inputs",
                           "step.launch", "frontend.consume",
                           "frontend.fetch_wait", "frontend.spawn",
                           "frontend.spawn_finalize"}
        _assert_partition(f, ("frontend.neighborhood", "frontend.dispatch",
                              "frontend.consume"))
        assert dispatch == sp["frontend.dispatch"][0]
        assert wait == 0.0  # a CPU fetch is never pending
        assert consume == sp.get("frontend.consume", (0.0,))[0]
        for name in ("frontend.candidates", "frontend.inputs",
                     "step.launch"):
            assert sp[name][2] == 1
    # the first entry also holds process_first_frame's spans
    assert log[0][-1]["spans"]["step.launch"][2] == 2


def test_frame_syncs_fixed_but_on_spawn_frames(port_run):
    # a host frame's upload every frame; a spawn's 3 pose copies and 2
    # spawn uploads more (the first entry holds process_first_frame's frame and
    # keyframe too)
    ft, *_ = port_run
    assert ft.neighborhood is None  # no backend: no adoption
    plain = []
    for i, (*_, f) in enumerate(ft.timing_log):
        spawns = f["spans"].get("frontend.spawn", (0, 0, 0))[2]
        frames_in = 2 if i == 0 else 1
        assert f["syncs"]["frame.upload"] == frames_in
        assert sum(f["syncs"].values()) == frames_in + 5 * spawns
        plain.append(spawns == 0)
    assert sum(plain[1:]) >= 3 and not all(plain[1:])  # a mid-run spawn


def test_frame_spans_on_the_profilers_clock(port_run):
    *_, traced = port_run
    assert {"frontend.dispatch", "step.launch", "frontend.consume"} <= traced


class TestEffectiveDepth:
    """The staleness guard (StereoFrontend._effective_depth), pure host
    policy (tests/test_frontend_vo.py:108-154)."""

    def _fe(self, depth):
        fe = TFrontend(T_CAM, TConfig(), device=CPU)
        fe.pipeline_depth = depth
        return fe

    def test_no_clamp_before_warmup_or_when_slow(self):
        fe = self._fe(4)
        assert fe._effective_depth() == 4  # no rotation history yet
        for _ in range(8):
            fe._rot_hist.append(np.radians(0.2))  # slow pan
        assert fe._effective_depth() == 4

    def test_clamps_fast_rotation(self):
        # 4 deg/frame at f=195 with the 16 px search radius: budget ~16 deg
        # -> depth 3 admitted, 4 clamped; warns once
        fe = self._fe(4)
        for _ in range(8):
            fe._rot_hist.append(np.radians(4.0))
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assert fe._effective_depth() == 3
            assert any("staleness budget" in str(x.message) for x in w)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            fe._effective_depth()
            assert not w

    def test_auto_depth_off_respects_raw_depth(self):
        fe = self._fe(4)
        fe.auto_depth = False
        for _ in range(8):
            fe._rot_hist.append(np.radians(30.0))
        assert fe._effective_depth() == 4

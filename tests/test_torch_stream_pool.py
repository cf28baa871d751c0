"""StreamPool (scavislam_tpu_torch.parallel.stream_pool): N live VO streams
through one batched step per tick with per-stream host keyframe policy, on
the CPU (tests/test_parallel.py::TestStreamPool at one device), and the
renderer's varied_box scenes against the JAX package's.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from scavislam_tpu.core.camera import StereoCamera as JCam
from scavislam_tpu.io import synthetic as jsyn
from scavislam_tpu_torch import interop
from scavislam_tpu_torch.io.synthetic import (
    SyntheticSequence,
    default_room,
    varied_box,
)
from scavislam_tpu_torch.models.frontend_step import DENSE_SUBS_BATCHED
from scavislam_tpu_torch.ops import stereo_bm
from scavislam_tpu_torch.parallel.stream_pool import StreamPool
from scavislam_tpu_torch.utils import perfmon
from scavislam_tpu_torch.utils.config import Config

J_CAM = JCam.create(195.0, (127.0, 95.0), (256, 192), 0.12)
T_CAM = interop.camera(np.asarray(J_CAM.focal), np.asarray(J_CAM.pp),
                       J_CAM.size, np.asarray(J_CAM.baseline))
N_FRAMES, B = 14, 2
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


def _ate(traj, gt):
    errs = [T.R @ (-Tg.R.numpy().T @ Tg.t.numpy()) + T.t
            for T, Tg in zip(traj, gt)]
    return float(np.sqrt((np.stack(errs) ** 2).sum(axis=1).mean()))


@pytest.fixture(scope="module")
def pool_run():
    # low parallax threshold so keyframe spawns happen mid-run (the
    # deferred spawn and epoch-guard paths run in pool mode)
    cfg = Config()
    cfg = dataclasses.replace(cfg, ui=dataclasses.replace(cfg.ui, parallax_thr=0.1))
    seqs = [SyntheticSequence(T_CAM, n_frames=N_FRAMES, step=0.02,
                              planes=default_room() if s == 0 else varied_box(1),
                              device=CPU)
            for s in range(B)]
    ticks = [[{"frame_id": i, "left": f["left"].numpy(),
               "right": f["right"].numpy()}
              for f in (q.frame(i) for q in seqs)] for i in range(N_FRAMES)]
    batched = stereo_bm.block_matching_disparity_bm_batched.launches
    single = stereo_bm.block_matching_disparity_bm.launches
    pool = StreamPool(T_CAM, cfg, n_streams=B, pipeline_depth=2,
                      device=CPU)
    pool.timing_log = []
    # the last tick runs under the profiler; record_function is counted
    entered = []

    def counting(name):
        entered.append(name)
        return real_rf(name)

    real_rf = perfmon.record_function
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(perfmon, "record_function", counting)
        first = pool.process_first_frames(ticks[0])
        results = [pool.process_frames(t) for t in ticks[1:-1]]
        unprofiled = list(entered)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            results.append(pool.process_frames(ticks[-1]))
        traced = {e.name for e in prof.events()}
    results += pool.finish()
    launches = (stereo_bm.block_matching_disparity_bm_batched.launches - batched,
                stereo_bm.block_matching_disparity_bm.launches - single)
    spans = {"unprofiled": unprofiled, "entered": entered[len(unprofiled):],
             "traced": traced}
    return pool, seqs, first, results, launches, spans


def test_two_streams_end_to_end(pool_run):
    pool, seqs, first, results, launches, _ = pool_run
    assert [p.kf_id for p in first] == [0] * B
    for s in range(B):
        assert pool.alive[s], f"stream {s} lost tracking"
        traj = pool.trajectories[s]
        assert [fid for fid, _ in traj] == list(range(N_FRAMES))
        # mid-run keyframes spawned (deferred spawn path)
        assert pool.fes[s].next_kf >= 2, f"stream {s}: no mid-run keyframe"
        ate = _ate([T for _, T in traj], [seqs[s].poses[i] for i, _ in traj])
        assert ate < 0.05, f"stream {s} ATE {ate}"
        assert pool.fes[s].dense_subs == DENSE_SUBS_BATCHED
    # streams tracked different scenes: the estimates differ
    t_end0 = pool.trajectories[0][-1][1].t
    t_end1 = pool.trajectories[1][-1][1].t
    assert np.any(np.abs(t_end0 - t_end1) > 0), "streams identical"
    # one batched step per tick: the per-stream frontends never ran their
    # own step, and on the CPU no kernel was launched
    assert all(fe._dev_R_cw is None for fe in pool.fes)
    assert launches == (0, 0)
    # one consume per tick after the pipeline filled, one entry per stream
    ticks = [r for r in results if r is not None]
    assert len(ticks) == N_FRAMES - 1
    assert all(len(r) == B and all(ok for ok, _, _ in r) for r in ticks)
    assert len(pool.timing_log) == N_FRAMES - 1


def test_packets_and_keyframe_counts(pool_run):
    pool, _, _, _, _, _ = pool_run
    pkts = pool.take_ready_packets()
    counts = pool.keyframe_counts()
    # every mid-run keyframe's packet landed by finish(); the first
    # keyframe's packet went out from process_first_frames
    assert sorted({s for s, _ in pkts}) == list(range(B))
    for s in range(B):
        kf_ids = [p.kf_id for t, p in pkts if t == s]
        assert kf_ids == list(range(1, counts[s]))
        assert all(len(p.new_point_ids) > 0 for t, p in pkts if t == s)
    assert pool.take_ready_packets() == []


def _assert_partition(folded, roots):
    """Each span within its parent (self time >= 0), and the roots' totals
    the sum of every span's self time."""
    spans = folded["spans"]
    for name, (total, own, n) in spans.items():
        assert n >= 1 and -1e-9 <= own <= total + 1e-9, name
    assert sum(own for _, own, _ in spans.values()) == pytest.approx(
        sum(spans[r][0] for r in roots if r in spans), rel=1e-9, abs=1e-12)


def test_tick_spans_partition_the_tick(pool_run):
    pool, _, _, _, _, _ = pool_run
    log = pool.timing_log
    for dispatch, wait, consume, f in log[1:]:
        sp = f["spans"]
        assert set(sp) <= {"pool.dispatch", "pool.candidates", "pool.inputs",
                           "step.launch", "pool.consume", "pool.fetch_wait",
                           "frontend.consume", "frontend.spawn",
                           "frontend.spawn_finalize"}
        _assert_partition(f, ("pool.dispatch", "pool.consume"))
        # the fields are the spans' totals
        assert dispatch == sp["pool.dispatch"][0]
        assert sp["pool.candidates"][2] == sp["step.launch"][2] == 1
        if "pool.consume" in sp:
            assert wait == sp["pool.fetch_wait"][0]
            assert consume == pytest.approx(sp["pool.consume"][0] - wait)
            # each stream's consume, summed by name
            assert sp["frontend.consume"][2] == B
            assert sum(f["streams"]) == pytest.approx(
                sp["frontend.consume"][0])
        else:  # the pipeline filling
            assert (wait, consume, f["streams"]) == (0.0, 0.0, [0.0] * B)
    assert sum("pool.consume" in x[-1]["spans"] for x in log) == N_FRAMES - 3


def test_tick_syncs_are_the_spawns_pageable_uploads(pool_run):
    # host frames go up pinned and the fetch is never pending on the CPU:
    # a tick's only counted sites are a spawn's 3 pose copies and 2 spawn
    # uploads
    pool, _, _, _, _, _ = pool_run
    spawned = 0
    for *_, f in pool.timing_log:
        n = f["spans"].get("frontend.spawn", (0, 0, 0))[2]
        assert sum(f["syncs"].values()) == 5 * n
        spawned += n
    assert spawned >= B
    assert pool.spans.syncs["keyframe.pose"] == 3 * sum(
        pool.keyframe_counts())


def test_tick_spans_on_the_profilers_clock(pool_run):
    *_, spans = pool_run
    assert spans["unprofiled"] == []
    assert {"pool.dispatch", "step.launch", "pool.consume",
            "frontend.consume"} <= set(spans["entered"])
    assert {"step.launch", "pool.consume", "frontend.consume"} \
        <= spans["traced"]


def test_varied_box_matches_jax():
    # the same per-seed texture phases, and the same geometry: disp_gt
    # within 1e-5 on frame 3 of the forward arc
    for seed in (1, 5):
        jp, tp = jsyn.varied_box(seed), varied_box(seed)
        assert len(jp) == len(tp) == 6
        for a, b in zip(jp, tp):
            assert float(np.asarray(a.tex_phase)) == b.tex_phase
            np.testing.assert_array_equal(np.asarray(a.normal), b.normal)
    jf = jsyn.SyntheticSequence(J_CAM, n_frames=4, planes=jsyn.varied_box(3)).frame(3)
    tf = SyntheticSequence(T_CAM, n_frames=4, planes=varied_box(3),
                           device=CPU).frame(3)
    np.testing.assert_allclose(tf["disp_gt"].numpy(), np.asarray(jf["disp_gt"]),
                               atol=1e-5)
    assert varied_box(3) != varied_box(4)

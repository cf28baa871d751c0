"""The end-to-end arithmetic and the per-layer readers on synthetic logs
and a synthetic trace."""

import types

import numpy as np
import pytest
import torch

from perfbench.core import arith, manifest, trace
from perfbench.core.harness import Record
from perfbench.gen.lie import SE3


def test_rate_is_all_poses_over_the_whole_window():
    # 450 poses in 30 s, however unevenly they came
    assert arith.frames_per_s(450, 30.0) == 15.0


def test_p95_is_over_all_frames_not_chunk_medians():
    lat = [100.0] * 95 + [1000.0] * 5
    # numpy's linear interpolation over all 100 samples
    assert arith.p95(lat) == pytest.approx(np.percentile(lat, 95))
    chunks = [np.median(lat[i:i + 10]) for i in range(0, 100, 10)]
    assert arith.p95(lat) != pytest.approx(np.percentile(chunks, 95))
    assert arith.p95(list(range(1, 101))) == pytest.approx(95.05)


def _pose(t):
    return types.SimpleNamespace(R=np.eye(3), t=np.asarray(t, np.float64))


def _gt(t):
    return SE3(torch.eye(3), torch.tensor(t, dtype=torch.float32))


def test_ate_uses_the_fixed_prefix():
    gt = {i: _gt([0.0, 0.0, 0.0]) for i in range(10)}
    traj = [(i, _pose([0.1, 0.0, 0.0])) for i in range(4)]
    traj += [(i, _pose([5.0, 0.0, 0.0])) for i in range(4, 10)]
    rmse, n = arith.prefix_ate(traj, gt, 4)
    assert n == 4 and rmse == pytest.approx(0.1)
    # a run that returned more frames is judged on the same prefix
    rmse2, n2 = arith.prefix_ate(traj + [(10, _pose([9, 9, 9]))],
                                 {**gt, 10: _gt([0.0, 0.0, 0.0])}, 4)
    assert (rmse2, n2) == (rmse, n)


def test_ate_is_the_translation_of_est_times_gt_inverse():
    gt = [_gt([1.0, 2.0, 3.0])]
    est = [_pose([1.0, 2.0, 3.5])]
    assert arith.ate(est, gt) == pytest.approx(0.5)


def test_bound_is_the_larger_of_operations_and_bytes():
    b, by = arith.bound_ms(1, 384, 512, 64)
    assert by == "operations"
    assert b == pytest.approx(1e3 * 25 * 384 * 512 * 64 / 67e12)
    b8, _ = arith.bound_ms(8, 384, 512, 64)
    assert b8 == pytest.approx(8 * b)


class _Ev:
    def __init__(self, name, dev, start, dur, corr=0, link=0, tid=1,
                 stream=7):
        self._n, self._d, self._s, self._u = name, dev, start, dur
        self._c, self._l, self._t, self._r = corr, link, tid, stream

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._s + self._u

    def duration_ns(self):
        return self._u

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def start_thread_id(self):
        return self._t

    def device_resource_id(self):
        return self._r

    def is_user_annotation(self):
        return self._n == "frame"


def _events():
    return [
        # the mark: a kernel on the calling thread's stream (7)
        _Ev(trace.MARK, False, -100, 50, corr=90),
        _Ev("aten::add_", False, -90, 20, corr=91),
        _Ev("k0", True, -80, 5, corr=92, link=91),
        _Ev("frame", False, 0, 1000, corr=1),
        _Ev("frame", False, 1000, 1000, corr=2),
        _Ev("frame", True, 0, 2000),  # the span's copy on the device
        _Ev("cudaGraphLaunch", False, 10, 5, corr=7),
        _Ev("cudaGraphLaunch", False, 1010, 5, corr=9),
        _Ev("cudaGraphLaunch", False, 20, 5, corr=11, tid=2),  # backend
        _Ev("k1", True, 100, 200, corr=7),
        _Ev("bm_cost_kernel", True, 300, 100, corr=7),
        _Ev("bm_lr_kernel", True, 400, 50, corr=7),
        _Ev("k1", True, 1100, 300, corr=9),
        # the backend's graph on its own stream, during frame 1
        _Ev("k2", True, 1200, 50, corr=11, stream=20),
        _Ev("k3", True, 1600, 10, corr=3, link=2),  # not a graph's
        _Ev("aten::copy_", False, 500, 400, tid=1),
    ]


def test_trace_summary_busy_launches_and_gaps():
    s = trace.summarize(_events(), "frame")
    assert s["window_s"] == pytest.approx(2000e-9)
    assert s["busy_s"] == pytest.approx(660e-9)
    # the backend thread's launch is not the entry's program
    assert sorted(s["graph_launches"]) == [(1, 300e-9), (3, 350e-9)]
    assert s["bm_calls"] == 1 and s["bm_s"] == pytest.approx(150e-9)
    gap_names = [g[0] for g in s["idle_gaps"]]
    assert gap_names[0] == "frame 0: aten::copy_"  # 450..1100, the longest
    assert s["idle_gaps"][0][1] == pytest.approx(650e-9)


def test_readers_on_synthetic_logs():
    s = trace.summarize(_events(), "frame")
    rec = Record({"fe_timing": [(1, 0.004, 0.050, 0.006),
                                (2, 0.006, 0.030, 0.004)],
                  "pool_timing": [(0.006, 0.048, 0.040)],
                  "solve_ms": [6.0, 5.0, 9.0],
                  "closed_loops": 2, "indexed": 8,
                  "bm_shape": (1, 384, 512, 64)}, s)

    def read(name):
        return manifest.load_reader(name)(rec)

    assert read("frontend.fetch_wait_ms") == pytest.approx(40.0)
    assert read("frontend.host_ms") == pytest.approx(10.0)
    assert read("pool.fetch_wait_ms") == pytest.approx(48.0)
    assert read("pool.consume_ms") == pytest.approx(40.0)
    assert read("graph.solve_ms") == 6.0
    assert read("step.kernels") == 2.0
    assert read("step.device_ms") == pytest.approx(1e3 * 325e-9)
    assert read("device.idle_pct") == pytest.approx(100 * (1 - 660 / 2000))
    bound = arith.bound_ms(1, 384, 512, 64)[0] / 1e3
    assert read("stereo_bm_roofline") == pytest.approx(
        100 * bound / 150e-9)


def test_readers_find_nothing_and_return_nothing():
    rec = Record({}, None)
    for m in manifest.load()["per_layer"]:
        assert manifest.load_reader(m["name"])(rec) is None, m["name"]


def test_the_seed_picks_the_checked_calls():
    from perfbench.core.traffic import check_positions
    t = {"check_span": 100, "check_frames": 2}
    seen = set()
    for seed in (1, 2**31 + 5, 3000000601, 2**40):
        pos = check_positions(t, seed)
        assert len(pos) == 2 and all(0 <= p < 100 for p in pos)
        seen.add(tuple(pos))
    assert len(seen) > 1
    assert check_positions(t, 7) == check_positions(t, 7)

"""An appearance loop closed end to end by the port's SlamSystem on the
CPU: the 360-degree spin in the closed box (benchmarks/run_configs.py
config 2's scene and configuration, unthreaded and synchronous), with the
backend's metric local registration switched off so that the revisit can
only reconnect through place recognition. The recognizer indexes every
keyframe from its spawn's pr_packed block, detects the revisit, and the
loop travels Backend.step -> place_monitor.getLoop() ->
global_loop_closure -> an APPEARANCE edge and pushClosedLoop ->
SlamSystem.closed_loops."""

import dataclasses

import numpy as np
import pytest
import torch

from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.io.synthetic import SyntheticSequence, closed_box
from scavislam_tpu_torch.models.slam_graph import APPEARANCE
from scavislam_tpu_torch.pipeline.slam_system import SlamSystem, ate_rmse
from scavislam_tpu_torch.utils.config import Config

CAM = StereoCamera.create(195.0, (127.0, 95.0), (256, 192), 0.12)
N = 90


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_appearance_loop_closes_end_to_end():
    cfg = Config()
    cfg = dataclasses.replace(
        cfg, frontend=dataclasses.replace(cfg.frontend, covis_thr=10),
        ui=dataclasses.replace(cfg.ui, parallax_thr=0.25),
        graph=dataclasses.replace(cfg.graph, inner_window=3, outer_window=8))
    seq = SyntheticSequence(CAM, n_frames=N, kind="spin", planes=closed_box(),
                            step=1.0 / (N - 1), device="cpu")
    system = SlamSystem(CAM, cfg, threaded=False, pr_lossless=True,
                        device="cpu")
    system.backend.local_register_frame = lambda root_id: False
    frames = [seq.frame(i) for i in range(N)]
    system.process_first_frame(frames[0])
    for f in frames[1:]:
        assert system.process_frame(dict(f)), f["frame_id"]
    system.finish()
    system.shutdown()

    pr, be, g = system.place_recognizer, system.backend, system.backend.graph
    assert pr.counters["indexed"] == system.frontend.next_kf
    assert pr.counters["described"] == 0
    assert pr.counters["loops_emitted"] >= 1
    assert be.counters["glc_accepted"] >= 1
    loops = [(a, b) for (a, b), e in g.edges.items()
             if e.edge_type == APPEARANCE]
    assert loops and all(abs(a - b) > 4 for a, b in loops)
    # the closed loop reached the frame thread as (query, loop)
    assert sorted(tuple(sorted(x)) for x in system.closed_loops) == sorted(
        loops)
    gt = {i: f["T_cw_gt"] for i, f in enumerate(frames)}
    traj = [(fid, T) for fid, T in system.trajectory if fid in gt]
    assert len(traj) == N
    assert ate_rmse(traj, [gt[fid] for fid, _ in traj]) < 0.1
    assert not system.lost and np.isfinite(
        [T.t for _, T in traj]).all()

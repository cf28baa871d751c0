"""Where the port's backend spends its time on one CUDA card.

Run from the root of a checkout, on a machine with a card:

    python3 probes/backend_probe.py

After 40 frames of the wander in the closed box through the unthreaded
SlamSystem at 512x384 with Config() defaults, it prints:

1. sync: the synchronizing operations torch's sync debug mode reports
   over one solve_ba and one registration dispatch;
2. solve / registration: the wall time of an eager call (host and device)
   beside the device time of the same call captured as a CUDA graph and
   replayed (median of CUDA-event timings);
3. threads: SlamSystem threaded and pipelined at depth 3 on the 80 frames,
   frames/s over frames 2..79 and the per-frame dispatch time, with the
   backend thread's idle poll at 1, 5 and 20 ms, with a backend that polls
   but does no work, and the pipelined frontend alone, in turns (each
   setting twice, the second pass in reverse order).

The last line is the card's name and power limit as nvidia-smi reports
them; no check fails the run.
"""

import collections
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scavislam_tpu_torch.core.camera import StereoCamera  # noqa: E402
from scavislam_tpu_torch.io.synthetic import (  # noqa: E402
    SyntheticSequence,
    closed_box,
)
from scavislam_tpu_torch.models import backend as backend_mod  # noqa: E402
from scavislam_tpu_torch.models.ba_solver import solve_ba  # noqa: E402
from scavislam_tpu_torch.models.dense_tracker import (  # noqa: E402
    to_device_pose,
)
from scavislam_tpu_torch.models.frontend import StereoFrontend  # noqa: E402
from scavislam_tpu_torch.models.map_store import (  # noqa: E402
    materialize_points,
)
from scavislam_tpu_torch.models.slam_graph import _unpack_problem  # noqa: E402
from scavislam_tpu_torch.pipeline.slam_system import SlamSystem  # noqa: E402
from scavislam_tpu_torch.utils.config import Config  # noqa: E402


def _graph_replay_ms(fn, runs):
    """fn captured as a CUDA graph: median device ms of `runs` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _eager_ms(fn, runs):
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def _sync_ops(fn):
    """{message @ file:line: count} of the synchronizing ops in fn()."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    found = collections.Counter(
        f"{str(w.message)[:60]} @ {os.path.basename(w.filename)}:{w.lineno}"
        for w in caught if "prototype" not in str(w.message))
    return dict(found)


def _threaded_run(cam, cfg, dev, frames, kind, poll_s):
    backend_mod.POLL_IDLE_S = poll_s
    system = None
    if kind == "frontend alone":
        fe = StereoFrontend(cam, cfg, device=dev)
        fe.pipeline_depth = 3
        first, step, flush = (fe.process_first_frame,
                              fe.process_frame_pipelined, fe.flush_pipeline)
    else:
        system = SlamSystem(cam, cfg, threaded=True, enable_loop_closure=False,
                            pipelined=True, pipeline_depth=3, device=dev)
        if kind == "idle backend":
            system.backend.step = lambda: False
        fe = system.frontend
        first, step, flush = (system.process_first_frame,
                              system.process_frame, system._flush_frontend)
    fe.timing_log = []
    try:
        first(frames[0])
        step(frames[1])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for f in frames[2:]:
            step(f)
        flush()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        if system is not None:
            system.finish()
            system.shutdown()
    dispatch = 1e3 * float(np.mean([x[1] for x in fe.timing_log]))
    print(f"threads: {kind}, idle poll {1e3 * poll_s:.0f} ms: "
          f"{(len(frames) - 2) / (t2 - t1):.2f} frames/s, {fe.next_kf} "
          f"keyframes, dispatch {dispatch:.2f} ms per frame", flush=True)


def main():
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card")
        sys.exit(1)
    dev = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    cfg = Config()
    cam = StereoCamera.create(cfg.cam.f, (cfg.cam.px, cfg.cam.py),
                              (cfg.cam.width, cfg.cam.height),
                              cfg.cam.baseline)
    seq = SyntheticSequence(cam, n_frames=80, kind="wander",
                            planes=closed_box(), step=0.06, device=dev)
    frames = [{"frame_id": i, "left": f["left"], "right": f["right"]}
              for i, f in ((i, seq.frame(i)) for i in range(80))]

    system = SlamSystem(cam, cfg, threaded=False, enable_loop_closure=False,
                        device=dev)
    system.process_first_frame(frames[0])
    for f in frames[1:40]:
        system.process_frame(f)
    system.finish()
    be, g = system.backend, system.backend.graph
    cam_params, buf, caps = g.last_problem
    prob, aperm = _unpack_problem(buf, caps)
    kf = max(be.keyframe_snapshots)
    snap = be.keyframe_snapshots[kf]
    pts, poses = be._last_tables
    cand = np.flatnonzero(pts.valid.cpu().numpy())[:1024]

    def solve():
        return solve_ba(cam_params, prob, iters=2, anchor_perm=aperm)

    def dispatch():
        return be._match_and_align_dispatch(snap, g.vertices[kf].T, cand, pts,
                                            poses)

    def register():
        return dispatch()[1].result()

    with torch.cuda.stream(be.stream):
        print(f"sync: solve_ba {_sync_ops(solve)}; registration dispatch "
              f"{_sync_ops(dispatch)}", flush=True)
        print(f"solve: {int(prob.pose_valid.sum())} poses, "
              f"{int(prob.point_valid.sum())} points, "
              f"{int(prob.obs_valid.sum())} observations at caps {caps}: "
              f"eager {_eager_ms(solve, 5):.2f} ms wall, CUDA graph replay "
              f"{_graph_replay_ms(solve, 25):.3f} device ms", flush=True)
        # the registration program alone (the fetch is outside the graph)
        ids = np.full(backend_mod.CAND_CAP, -1, np.int64)
        ids[:len(cand)] = cand
        ids_t = backend_mod._upload(ids, dev)
        xyz_w, R_aw, t_aw, patches, ok = materialize_points(poses, pts, ids_t)
        lvl = pts.level[ids_t.clamp(0, pts.level.shape[0] - 1)].to(torch.int32)
        cam_key = tuple((float(c.focal), float(c.pp[0]), float(c.pp[1]),
                         float(c.baseline), int(c.size[0]), int(c.size[1]))
                        for c in be.cams)
        fn = backend_mod._build_register_packed(
            cam_key, 0.18, float(cfg.ui.max_reproj_error) * 2.0)
        T0 = g.vertices[kf].T
        T0 = to_device_pose(np.asarray(T0.R, np.float32),
                            np.asarray(T0.t, np.float32), dev)

        def program():
            return fn(snap["pyr"], snap["disp"], T0.R, T0.t, xyz_w, R_aw,
                      t_aw, patches, ok, lvl, ids_t >= 0)

        print(f"registration: {len(cand)} candidates: eager "
              f"{_eager_ms(register, 3):.2f} ms wall with the fetch, CUDA "
              f"graph replay of the program {_graph_replay_ms(program, 10):.3f}"
              f" device ms", flush=True)

    order = [("frontend alone", 0.001), ("threaded", 0.001),
             ("threaded", 0.005), ("threaded", 0.020), ("idle backend", 0.001)]
    for kind, poll in order + order[::-1]:
        _threaded_run(cam, cfg, dev, frames, kind, poll)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()

"""What the stereo frame step costs as a CUDA graph, and what its replays
cost the other threads. Run from the root of a checkout:

    python3 probes/step_graph_probe.py ops         # on a CPU
    python3 probes/step_graph_probe.py contention  # needs a CUDA card

``ops``: the top-level ATen operations (each is one kernel launch on a
card) of one ``frontend_step`` at 256x192 with its LMs run to their last
trip, and of its parts: one dense LM level (level 0), one motion-only LM
round, one ``_ic_pass`` and one ``SE3.exp``.

``contention``: the backend's solve (``solve_ba`` on the last problem of a
30-frame unthreaded run at 256x192, the spin of ``chip_smoke.py`` phase 9)
alone, then while another thread replays the frame step's graph back to
back: wall ms of the eager solve and of the solve as a graph replay, on a
stream of default priority and on a high-priority one. The last line is
the card's name and power limit as nvidia-smi reports them.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from scavislam_tpu_torch.core.lie import SE3  # noqa: E402
from scavislam_tpu_torch.io.synthetic import (  # noqa: E402
    SyntheticSequence,
    closed_box,
)
from scavislam_tpu_torch.models import dense_tracker  # noqa: E402
from scavislam_tpu_torch.models import frontend_step as FS  # noqa: E402
from scavislam_tpu_torch.models import pose_optimizer  # noqa: E402
from scavislam_tpu_torch.models.frontend import StereoFrontend  # noqa: E402
from scavislam_tpu_torch.utils.config import Config  # noqa: E402


def _spin(dev, n):
    cam, cfg = chip_smoke._loop_cam_cfg(Config(), 0.25, windows=(3, 8))
    seq = SyntheticSequence(cam, n_frames=n, kind="spin", planes=closed_box(),
                            step=1.0 / (chip_smoke.LOOP_FRAMES - 1),
                            device=dev)
    frames = []
    for i in range(n):
        f = seq.frame(i)
        frames.append({"frame_id": i, "left": f["left"], "right": f["right"],
                       "T_cw_gt": f["T_cw_gt"]})
    return cam, cfg, frames


def _step_state(cam, cfg, frames, dev, n=6):
    """frontend_step's arguments for frame n after frames 0..n-1."""
    fe = StereoFrontend(cam, cfg, device=dev)
    fe.process_first_frame(frames[0])
    for f in frames[1:n]:
        fe.process_frame(f)
    return fe, chip_smoke._step_args(fe, frames[n])


def ops():
    from torch.profiler import ProfilerActivity, profile
    torch.set_num_threads(4)
    dense_tracker.EARLY_EXIT_ON_CPU = False  # every trip, as on a card
    cam, cfg, frames = _spin("cpu", 7)
    fe, (args, kwargs) = _step_state(cam, cfg, frames, "cpu")

    def count(fn):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
        return sum(1 for e in prof.events() if e.name.startswith("aten::")
                   and (e.cpu_parent is None
                        or not e.cpu_parent.name.startswith("aten::")))

    calls = []
    motion = FS.motion_only_ba

    def recording(*a, **k):
        calls.append((a, k))
        return motion(*a, **k)

    FS.motion_only_ba = recording
    step = count(lambda: FS.frontend_step(*args, **kwargs))
    FS.motion_only_ba = motion
    c, i, v, J = (x[0] for x in (fe._prev_clouds, fe._prev_intens,
                                 fe._prev_valids, fe._prev_J))
    img, eye, zero = fe.last_pyr[0], torch.eye(3), torch.zeros(3)
    a, k = calls[0]
    print(f"ops (CPU, 256x192, every trip): frame step {step}; dense LM "
          f"level 0 ({dense_tracker.MAX_ITERS * dense_tracker.MAX_TRIALS} "
          f"trips) {count(lambda: dense_tracker._lm_level_ic(fe.cams[0], img, c, i, J, v, eye, zero))}; "  # noqa: E501
          f"motion-only LM round ({pose_optimizer.MAX_ITERS} trips) "
          f"{count(lambda: pose_optimizer.motion_only_ba(*a, **k))}; "
          f"_ic_pass {count(lambda: dense_tracker._ic_pass(fe.cams[0], img, eye, zero, c, i, J, v))}; "  # noqa: E501
          f"SE3.exp {count(lambda: SE3.exp(torch.full((6,), 0.01)))}",
          flush=True)


def _wall(fn, k=5):
    times = []
    for _ in range(k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def contention():
    from scavislam_tpu_torch.models import ba_solver
    from scavislam_tpu_torch.models.slam_graph import _unpack_problem
    from scavislam_tpu_torch.models.step_graph import StepGraph
    dev = torch.device("cuda", 0)
    cam, cfg, frames = _spin(dev, 30)
    r = chip_smoke._run_system(cam, cfg, dev, frames, threaded=False,
                               pipelined=False)
    cam_params, buf, caps = r["system"].backend.graph.last_problem
    prob, aperm = _unpack_problem(buf, caps)

    def solve():
        return ba_solver.solve_ba(cam_params, prob, iters=2, huber=3.0,
                                  anchor_perm=aperm)

    g_solve, _ = chip_smoke._graph_of(solve)
    _, (args, kwargs) = _step_state(cam, cfg, frames, dev)
    step = StepGraph()
    step(*args, **kwargs)
    print(f"contention: alone: solve eager {_wall(solve):.1f} ms, as a graph "
          f"{_wall(g_solve.replay):.2f} ms; the step's replay "
          f"{_wall(lambda: step(*args, **kwargs)):.1f} ms (wall)", flush=True)
    for priority in (0, -1):
        stop, replays = threading.Event(), [0]

        def loop():
            while not stop.is_set():
                step(*args, **kwargs)
                replays[0] += 1

        thread = threading.Thread(target=loop)
        thread.start()
        time.sleep(1.0)
        with torch.cuda.stream(torch.cuda.Stream(dev, priority=priority)):
            eager, graph = _wall(solve), _wall(g_solve.replay)
        stop.set()
        thread.join()
        print(f"contention: beside the step's replays in another thread, on "
              f"a stream of priority {priority}: solve eager {eager:.1f} ms, "
              f"as a graph {graph:.2f} ms ({replays[0]} replays)", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    {"ops": ops, "contention": contention}[sys.argv[1]]()

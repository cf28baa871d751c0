"""Where a stream pool tick's synchronizing calls come from. Needs a CUDA
card; run from the root of a checkout:

    python3 probes/pool_sync_probe.py

Eight streams (``chip_smoke.py`` phase 7's scenes, 512x384, ``Config()``,
depth 2) for 12 ticks; each tick runs under sync debug mode "warn", and
the warnings are counted by the source line that made them. Prints per
tick the keyframe counts before and after, the synchronizing calls and
their lines, and the tick's wall ms. The last line is the card's name and
power limit as nvidia-smi reports them.
"""

import collections
import os
import subprocess
import sys
import time
import warnings

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from scavislam_tpu_torch.core.camera import StereoCamera  # noqa: E402
from scavislam_tpu_torch.io.synthetic import SyntheticSequence  # noqa: E402
from scavislam_tpu_torch.parallel.stream_pool import StreamPool  # noqa: E402
from scavislam_tpu_torch.utils.config import Config  # noqa: E402

N_TICKS = 12


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    cfg = Config()
    cam = StereoCamera.create(cfg.cam.f, (cfg.cam.px, cfg.cam.py),
                              (cfg.cam.width, cfg.cam.height),
                              cfg.cam.baseline)
    seqs = [SyntheticSequence(cam, n_frames=N_TICKS + 1, kind="wander",
                              planes=p, step=0.06, device=dev)
            for p in chip_smoke._scenes(chip_smoke.N_STREAMS)]
    ticks = [[{"frame_id": i, "left": f["left"], "right": f["right"]}
              for f in (q.frame(i) for q in seqs)]
             for i in range(N_TICKS + 1)]
    pool = StreamPool(cam, cfg, n_streams=chip_smoke.N_STREAMS,
                      pipeline_depth=2, device=dev)
    pool.process_first_frames(ticks[0])
    torch.cuda.synchronize()
    for i, tick in enumerate(ticks[1:], 1):
        kf0 = pool.keyframe_counts()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                pool.process_frames(tick)
                ms = 1e3 * (time.perf_counter() - t0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        lines = collections.Counter(
            f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
            for w in caught if "synchroniz" in str(w.message))
        print(f"tick {i}: keyframes {kf0} -> {pool.keyframe_counts()}, "
              f"{sum(lines.values())} synchronizing calls {dict(lines)}, "
              f"{ms:.1f} wall ms", flush=True)
    pool.finish()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()

"""The benchmark's own tests: run from the repository root with
``python -m pytest perfbench/tests``. They need no card; the card test
(``cuda`` marker) skips without one."""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a few intra-op threads a process, so that test processes run side by side
# (pytest -n) do not starve each other's runs
torch.set_num_threads(min(2, torch.get_num_threads()))

TINY_CAMERA = {"width": 128, "height": 96, "f": 97.5, "px": 63.5,
               "py": 47.5, "baseline": 0.12}
TINY_TRAFFIC = {"max_frames": 40, "ate_frames": 10, "warmup_frames": 4,
                "check_frames": 6, "check_span": 8, "trace_frames": 2}

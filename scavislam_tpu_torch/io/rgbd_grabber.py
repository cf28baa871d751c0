"""Live RGB-D grabber with the reference's polling monitor semantics (port
of scavislam_tpu.io.rgbd_grabber; numpy only).

The reference's RgbdGrabber: a camera callback thread fills the latest
RGB + float-disparity pair under a mutex, and the consumer polls
``getFrame``, which copies the latest pair out under the same mutex. Frames
between polls are dropped (latest value wins).

The capture backend is pluggable: any zero-argument callable returning
``(rgb (H, W[, 3]) uint8/float, disp (H, W) float32)``, or None at the end
of the stream: a camera SDK binding, a replay of a dump_sequence directory
(:func:`directory_source`), or a synthetic source.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Tuple

import numpy as np

Frame = Tuple[np.ndarray, np.ndarray]


class RgbdGrabber:
    """Polling grabber: a producer thread stores the newest RGB-D pair."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rgb: Optional[np.ndarray] = None
        self._disp: Optional[np.ndarray] = None
        self._fresh = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- producer side ---------------------------------------------------- #
    def start(self, source: Callable[[], Optional[Frame]], fps: float = 30.0):
        """Spawn the capture thread. `source` is polled at ~fps; returning
        None ends the stream (a live camera source never returns None)."""
        period = 1.0 / max(fps, 1e-3)

        def run():
            while not self._stop.is_set():
                t0 = time.perf_counter()
                frame = source()
                if frame is None:
                    break
                rgb, disp = frame
                with self._lock:
                    self._rgb = np.asarray(rgb)
                    self._disp = np.asarray(disp, np.float32)
                    self._fresh = True
                dt = time.perf_counter() - t0
                if dt < period:
                    time.sleep(period - dt)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    # -- consumer side ---------------------------------------------------- #
    def getFrame(self) -> Optional[Frame]:  # noqa: N802 (reference name)
        """Copy the newest unseen frame out, or None if nothing new."""
        with self._lock:
            if not self._fresh or self._rgb is None:
                return None
            self._fresh = False
            return self._rgb.copy(), self._disp.copy()


def directory_source(path: str, cam=None, loop: bool = False):
    """Replay a dump_sequence directory as a live source: a callable for
    :meth:`RgbdGrabber.start`."""
    from scavislam_tpu_torch.io.filegrabber import FileGrabber

    def open_grabber():
        return FileGrabber(path, base_pattern="img_.*", fmt="png",
                           right_img=False, disp_img=True)

    state = {"grabber": open_grabber()}

    def source():
        f = state["grabber"].next_frame()
        if f is None:
            if not loop:
                return None
            state["grabber"].close()
            state["grabber"] = open_grabber()
            f = state["grabber"].next_frame()
            if f is None:
                return None
        rgb = f["left"]
        disp = f.get("disp")
        if disp is None:
            disp = np.zeros_like(np.asarray(rgb, np.float32))
        return np.asarray(rgb), np.asarray(disp, np.float32)

    return source

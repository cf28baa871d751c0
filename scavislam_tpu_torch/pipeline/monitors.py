"""Cross-thread mailboxes with the reference's channel semantics (a copy of
the jax-free scavislam_tpu.pipeline.monitors).

The reference's 4-5 thread pipeline communicates exclusively through
hand-written mutex-guarded "monitor" classes (SURVEY.md §1). The channel
SEMANTICS (not just thread safety) determine system behavior, so they are
replicated exactly:

- keyframes frontend->backend: FIFO queue (backend.cpp:72-90);
- neighborhood backend->frontend: latest-value cell, older values overwritten
  (backend.cpp:51-70);
- query frame-id frontend->backend: latest-value (backend.cpp:30-49);
- detected loops place-recognizer->backend: stack (LIFO), and the PR input
  queue keeps ONLY the newest keyframe and refuses new work while an
  unconsumed loop is pending (placerecognizer.cpp:36-63).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Optional


class FifoChannel:
    """Unbounded FIFO (frontend -> backend keyframe queue)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._q = deque()

    def push(self, item):
        with self._lock:
            self._q.append(item)

    def pop(self) -> Optional[Any]:
        with self._lock:
            return self._q.popleft() if self._q else None

    def __len__(self):
        with self._lock:
            return len(self._q)


class LatestValueCell:
    """Latest-value-only cell; writes overwrite, reads consume."""

    def __init__(self):
        self._lock = threading.Lock()
        self._val = None
        self._has = False

    def set(self, item):
        with self._lock:
            self._val = item
            self._has = True

    def take(self) -> Optional[Any]:
        with self._lock:
            if not self._has:
                return None
            self._has = False
            v = self._val
            self._val = None
            return v

    def peek(self):
        with self._lock:
            return self._val if self._has else None


class StackChannel:
    """LIFO stack (loops PR -> backend; to_optimizer in the frontend)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._s = []

    def push(self, item):
        with self._lock:
            self._s.append(item)

    def pop(self) -> Optional[Any]:
        with self._lock:
            return self._s.pop() if self._s else None

    def __len__(self):
        with self._lock:
            return len(self._s)


class BackendMonitor:
    """Parity: BackendMonitor (backend.h:48-93, backend.cpp:30-130).
    Five channels between main/frontend thread and the backend thread."""

    def __init__(self):
        self.keyframes = FifoChannel()  # pushKeyframe / getKeyframe
        self.query_frame_id = LatestValueCell()  # queryNeighborhood
        self.neighborhood = LatestValueCell()  # pushNeighborhood / getNeighborhood
        self.closed_loops = StackChannel()  # pushClosedLoop / getClosedLoop
        self.draw_data = LatestValueCell()  # pushDrawData / getDrawData
        # the backend builds its O(map) draw snapshot only when someone
        # consumes it (self-arming: the first getDrawData call flips this;
        # the reference's GUI always draws, headless runs never do)
        self.want_draw_data = False

    # reference method names
    def pushKeyframe(self, pkt):
        self.keyframes.push(pkt)

    def getKeyframe(self):
        return self.keyframes.pop()

    def queryNeighborhood(self, frame_id: int):
        self.query_frame_id.set(frame_id)

    def getQueryFrameId(self):
        return self.query_frame_id.take()

    def pushNeighborhood(self, nb):
        self.neighborhood.set(nb)

    def getNeighborhood(self):
        return self.neighborhood.take()

    def pushClosedLoop(self, loop):
        self.closed_loops.push(loop)

    def getClosedLoop(self):
        return self.closed_loops.pop()

    def pushDrawData(self, dd):
        self.draw_data.set(dd)

    def getDrawData(self):
        self.want_draw_data = True
        return self.draw_data.take()


class PlaceRecognizerMonitor:
    """Parity: PlaceRecognizerMonitor (placerecognizer.h:50-92,
    placerecognizer.cpp:36-84): input keeps only the NEWEST keyframe, and new
    work is refused while a detected loop awaits consumption.

    lossless=True switches the input channel to a FIFO that never drops or
    refuses keyframes. The reference's drop/refuse semantics shed load in a
    real-time run where keyframes arrive at ~1/s and PR keeps up; in a
    benchmark/offline run the whole sequence streams in seconds, so WHICH
    keyframes get BoW-indexed becomes a property of thread scheduling —
    measured on the loop-closure benchmark as run-to-run `reconnected`
    flips on identical code. Lossless mode makes loop detection a property
    of the code: every keyframe is indexed (during the run when PR keeps
    up, in SlamSystem.finish()'s drain otherwise)."""

    def __init__(self, lossless: bool = False):
        self._lock = threading.Lock()
        self.lossless = lossless
        self._newest_kf = None
        self._fifo = deque()
        self._loops = []

    def addKeyframeData(self, data):
        with self._lock:
            if self.lossless:
                self._fifo.append(data)
                return
            if self._loops:
                return  # refuse work while a loop is pending
            self._newest_kf = data

    def getKeyframeDate(self):  # sic — reference method name
        with self._lock:
            if self.lossless:
                return self._fifo.popleft() if self._fifo else None
            d = self._newest_kf
            self._newest_kf = None
            return d

    def addLoop(self, loop):
        with self._lock:
            self._loops.append(loop)

    def getLoop(self):
        with self._lock:
            return self._loops.pop() if self._loops else None

    def pending(self) -> bool:
        """True if unconsumed work sits in either direction (used by
        SlamSystem.finish to drain after the last frame)."""
        with self._lock:
            return (self._newest_kf is not None or bool(self._fifo)
                    or bool(self._loops))

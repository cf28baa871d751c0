"""Disk-sequence frame grabber: native decode, background prefetch, and a
copy of each frame onto the card off the frame loop (port of
scavislam_tpu.io.filegrabber).

The reference's FileGrabber + FrameGrabber file path: a recursive regex
scan for `<base>left.*\\.<fmt>$` images, a producer thread that prefetches
into a bounded 50-frame queue, strict frame-id order, left/right/disparity/
depth pairing, float32 disparity stored as 4-channel byte PNGs, and
depth -> disparity.

Scan and decode (PNM, 8-bit non-interlaced PNG) run in the repo's native
library, ``native/grabber.cpp``, compiled from the checkout at first use
with g++ into ``build/kernels/libsvtgrabber_<hash>.so`` and bound with
ctypes; a failed build raises with the compiler's output. Other files
(16-bit or palette PNG, JPEG) are decoded by PIL, imported only then.

``device_prefetch=True``: the producer thread stacks each frame into a
pinned host buffer from a small ring (a slot is reused once its copy has
completed) and copies it to `device` without blocking, on the grabber's own
CUDA stream, with a CUDA event recorded behind the copy. The bundle carries
the device tensor (``stacked_dev``: (2, H, W) uint8, or (3, H, W) float32
with an external disparity plane; ``left_dev``: one uint8 plane for a mono
stream) and that event (``upload_event``); the consumer's stream waits on
the event before reading the tensor and calls ``record_stream`` on it
(``models.frontend.StereoFrontend`` does both). On the CPU the tensor is
ready at once and the event is None.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from scavislam_tpu_torch import resolve_device

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "grabber.cpp"
BUILD_DIR = _REPO / "build" / "kernels"
_PATH_CAP = 4096
_RING_SLOTS = 4  # pinned staging buffers per grabber

_lib = None
_lib_lock = threading.Lock()  # the build, and svt_scan + svt_scan_get pairs


def _build() -> Path:
    """g++ -> build/kernels/libsvtgrabber_<hash>.so (skipped when present).
    Built to a temporary name and moved into place, so that processes
    building at once never load a half-written library."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libsvtgrabber_{digest}.so"
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the grabber's native library is "
                           f"built from {SOURCE}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, "-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall",
           "-o", str(tmp), str(SOURCE), "-lz"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed "
                           f"({' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _native():
    """The native library, built and bound once per process."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            lib.svt_scan.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
            lib.svt_scan.restype = ctypes.c_int
            lib.svt_scan_get.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                         ctypes.c_int]
            lib.svt_scan_get.restype = ctypes.c_int
            i32p = ctypes.POINTER(ctypes.c_int)
            lib.svt_load_pnm.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
                i32p, i32p, i32p]
            lib.svt_load_pnm.restype = ctypes.c_int
            _lib = lib
        return _lib


def scan_dataset(path: str, base_pattern: str = ".*") -> list[str]:
    """Recursive regex scan of file names, sorted (ECMAScript regex,
    searched in each base name)."""
    lib = _native()
    with _lib_lock:
        n = lib.svt_scan(path.encode(), base_pattern.encode())
        if n < 0:
            raise ValueError(f"the native scanner refuses the pattern "
                             f"{base_pattern!r}")
        buf = ctypes.create_string_buffer(_PATH_CAP)
        out = []
        for i in range(n):
            if lib.svt_scan_get(i, buf, _PATH_CAP) < 0:
                raise ValueError(f"a path under {path} is longer than "
                                 f"{_PATH_CAP} bytes")
            out.append(buf.value.decode())
    return out


def load_image(path: str, size_hint: int = 0) -> np.ndarray:
    """Decode one image: uint8 (H, W), (H, W, 3) or (H, W, 4). PNM and
    8-bit non-interlaced PNG decode natively, in one pass when
    `size_hint` (bytes) is at least the image's size; anything else goes
    to PIL."""
    if path.lower().endswith((".pnm", ".pgm", ".ppm", ".png")):
        lib = _native()
        w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        buf = np.empty(max(size_hint, 0), np.uint8)
        err = lib.svt_load_pnm(path.encode(), buf.ctypes.data if size_hint
                               else None, buf.size, ctypes.byref(w),
                               ctypes.byref(h), ctypes.byref(c))
        if err in (0, -2):
            n = w.value * h.value * c.value
            if not size_hint or err == -2:
                buf = np.empty(n, np.uint8)
                err = lib.svt_load_pnm(path.encode(), buf.ctypes.data, n,
                                       ctypes.byref(w), ctypes.byref(h),
                                       ctypes.byref(c))
            if err == 0:
                img = buf[:n].reshape(h.value, w.value, c.value)
                return img[..., 0] if c.value == 1 else img
    from PIL import Image

    return np.asarray(Image.open(path))


def to_gray_f32(img: np.ndarray) -> np.ndarray:
    if img.ndim == 3:
        img = (
            0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
        )
    return np.asarray(img, np.float32) / 255.0


def _as_u8_gray(img: np.ndarray) -> np.ndarray:
    if img.ndim == 3:
        img = (0.299 * img[..., 0] + 0.587 * img[..., 1]
               + 0.114 * img[..., 2] + 0.5).astype(np.uint8)
    return np.asarray(img, np.uint8)


def disparity_from_png_bytes(img: np.ndarray) -> np.ndarray:
    """Float disparity stored as a 4-byte-per-pixel PNG: reinterpret."""
    if img.ndim != 3 or img.shape[2] != 4:
        raise ValueError(f"need an (H, W, 4) byte image, got {img.shape}")
    return img.astype(np.uint8).view(np.float32).reshape(img.shape[:2])


def depth_to_disp(depth: np.ndarray, focal: float, baseline: float):
    """disparity = f * b / depth; depth <= 1e-6 -> -1 (invalid)."""
    d = np.where(depth > 1e-6, focal * baseline / np.maximum(depth, 1e-6), -1.0)
    return d.astype(np.float32)


class _Uploader:
    """Host -> device copies of one grabber, on its own CUDA stream: a ring
    of pinned staging buffers, each reused once the copy out of it has
    completed (its event). On the CPU a copy is a plain tensor."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self._ring = []  # [pinned tensor, event of the last copy out of it]
        self._next = 0

    def _slot(self, shape, dtype):
        if not self._ring or self._ring[0][0].shape != shape \
                or self._ring[0][0].dtype != dtype:
            self._ring = [[torch.empty(shape, dtype=dtype, pin_memory=True),
                           None] for _ in range(_RING_SLOTS)]
            self._next = 0
        slot = self._ring[self._next]
        self._next = (self._next + 1) % len(self._ring)
        if slot[1] is not None:
            slot[1].synchronize()  # this thread waits, not the frame loop
        return slot

    def upload(self, planes, dtype, timed=False):
        """Stack `planes` (numpy arrays of one shape) and copy them to the
        device. Returns (tensor, event or None, (start, end) timing events
        or None)."""
        if self.stream is None:
            return torch.from_numpy(np.stack(planes).astype(dtype)), None, None
        tdtype = torch.uint8 if dtype == np.uint8 else torch.float32
        shape = (len(planes), *planes[0].shape)
        slot = self._slot(shape, tdtype)
        host = slot[0].numpy()
        for k, p in enumerate(planes):
            np.copyto(host[k], p, casting="unsafe")
        timing = None
        with torch.cuda.stream(self.stream):
            if timed:
                timing = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                timing[0].record(self.stream)
            dev = torch.empty(shape, dtype=tdtype, device=self.device)
            dev.copy_(slot[0], non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
            if timed:
                timing[1].record(self.stream)
        slot[1] = event
        return dev, event, timing


class FileGrabber:
    """Background prefetching frame source: frames come out strictly in
    index order, at most `max_buffer` decoded ahead.

    With `device_prefetch`, frames are also copied to `device` (the card
    by default) from the producer thread; see the module docstring. When
    `timing_log` is set to a list, the producer appends one
    (frame_id, decode_s, upload_events) tuple per frame, upload_events the
    (start, end) CUDA timing events of its copy or None."""

    def __init__(self, path: str, base_pattern: str = ".*",
                 fmt: str = "png", right_img: bool = True,
                 disp_img: bool = False, depth_img: bool = False,
                 skip: int = 0, max_buffer: int = 50,
                 focal: float = None, baseline: float = None,
                 device_prefetch: bool = False, device=None,
                 timing_log: list = None):
        left_pat = f"{base_pattern}left.*\\.{fmt}$"
        self.left_files = scan_dataset(path, left_pat)[skip:]
        self.right_img = right_img
        self.disp_img = disp_img
        self.depth_img = depth_img
        self.focal = focal
        self.baseline = baseline
        self.device_prefetch = device_prefetch
        self.timing_log = timing_log
        self._uploader = (_Uploader(resolve_device(device))
                          if device_prefetch else None)
        self._q: queue.Queue = queue.Queue(maxsize=max_buffer)
        self._stop = threading.Event()
        self._next_expected = 0
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def __len__(self):
        return len(self.left_files)

    def _derive(self, left_path, kind):
        """The companion file: "left" replaced by `kind` in the path."""
        if "left" in left_path:
            return left_path.replace("left", kind)
        root, e = os.path.splitext(left_path)
        return root + "_" + kind + e

    def _decode(self, lp, hint):
        bundle = {}
        bundle["left_u8"] = load_image(lp, hint)
        if self.right_img:
            bundle["right_u8"] = load_image(self._derive(lp, "right"), hint)
        if self.disp_img:
            raw = load_image(self._derive(lp, "disp"), 4 * hint)
            bundle["disp"] = disparity_from_png_bytes(raw)
        if self.depth_img:
            raw = load_image(self._derive(lp, "depth"), 4 * hint)
            bundle["disp"] = depth_to_disp(disparity_from_png_bytes(raw),
                                           self.focal, self.baseline)
        return bundle

    def _upload(self, bundle, timed):
        left = bundle["left_u8"]
        if not self.right_img and "disp" not in bundle:
            # a mono stream: one uint8 plane, no zero right plane
            dev, ev, timing = self._uploader.upload(
                [_as_u8_gray(left)], np.uint8, timed)
            bundle["left_dev"] = dev[0]
        else:
            right = bundle.get("right_u8", np.zeros_like(left))
            if "disp" in bundle:
                # external disparity rides a float stack (3, H, W), the
                # layout models.frontend_step.frontend_step takes
                planes = [to_gray_f32(left), to_gray_f32(right),
                          bundle["disp"]]
                dev, ev, timing = self._uploader.upload(planes, np.float32,
                                                        timed)
            else:
                dev, ev, timing = self._uploader.upload(
                    [_as_u8_gray(left), _as_u8_gray(right)], np.uint8, timed)
            bundle["stacked_dev"] = dev
        bundle["upload_event"] = ev
        return timing

    def _producer(self):
        hint = 0
        for i, lp in enumerate(self.left_files):
            if self._stop.is_set():
                return
            t0 = time.perf_counter()
            try:
                bundle = self._decode(lp, hint)
                hint = bundle["left_u8"].size
            except Exception as e:  # noqa: BLE001 - raised by next_frame
                bundle = {"error": f"{lp}: {type(e).__name__}: {e}"}
            decode_s = time.perf_counter() - t0
            bundle["frame_id"] = i
            timing = None
            if self._uploader is not None and "error" not in bundle:
                try:
                    timing = self._upload(bundle, self.timing_log is not None)
                except Exception as e:  # noqa: BLE001 - raised by next_frame
                    bundle["error"] = f"upload of {lp}: {type(e).__name__}: {e}"
            if self.timing_log is not None:
                self.timing_log.append((i, decode_s, timing))
            self._q.put(bundle)
        self._q.put(None)

    def __iter__(self):
        """Frames in index order until the sequence ends."""
        while True:
            f = self.next_frame()
            if f is None:
                return
            yield f

    def next_frame(self):
        """Blocking; a dict with float [0, 1] 'left' / 'right' (and 'disp';
        'stacked_dev' or 'left_dev' and 'upload_event' when prefetching to
        the device), or None at the end of the sequence."""
        b = self._q.get()
        if b is None:
            return None
        if b["frame_id"] != self._next_expected:
            raise RuntimeError(f"frame order violated: got {b['frame_id']}, "
                               f"expected {self._next_expected}")
        self._next_expected += 1
        if "error" in b:
            raise IOError(b["error"])
        out = {"frame_id": b["frame_id"], "left": to_gray_f32(b["left_u8"])}
        if "right_u8" in b:
            out["right"] = to_gray_f32(b["right_u8"])
        for k in ("disp", "stacked_dev", "left_dev", "upload_event"):
            if k in b:
                out[k] = b[k]
        return out

    def close(self):
        """Stop the producer and drop the frames still queued."""
        self._stop.set()
        self._drain()  # a producer blocked on the full queue puts, then stops
        self._thread.join(timeout=5.0)
        self._drain()

    def _drain(self):
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

"""Sequence recorder: write stereo / RGB-D frames in the reference's dump
format (port of scavislam_tpu.apps.dump_sequence).

A background FileWriter thread writes ``img_%06d_left.png`` (and
``_right.png``) as 8-bit gray PNGs and the float disparity as a 4-channel
byte PNG (``img_%06d_disp.png``: the f32 bytes reinterpreted as RGBA), so
that a recorded run replays byte-exactly through
``io.filegrabber.FileGrabber(disp_img=True)``. The PNGs are written by
utils/png.py (filter 0, one IDAT), which the native decoder reads; PIL is
not needed.

Usage: python -m scavislam_tpu_torch.apps.dump_sequence <out_dir>
[n_frames] [--source synthetic|live|dir:PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import queue
import threading

import numpy as np
import torch

from scavislam_tpu_torch.apps.stereo_slam import build_camera
from scavislam_tpu_torch.utils.png import write_png
from scavislam_tpu_torch.utils.config import Config

def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class FileWriter:
    """Background writer thread over a 50-frame queue."""

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self._q: queue.Queue = queue.Queue(maxsize=50)
        self.error = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def push(self, frame_id: int, left_u8, right_u8=None, disp_f32=None):
        self._q.put((frame_id, left_u8, right_u8, disp_f32))

    def _path(self, fid, kind):
        return os.path.join(self.out_dir, f"img_{fid:06d}_{kind}.png")

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if self.error is not None:
                continue  # keep draining so that push never blocks
            fid, left, right, disp = item
            try:
                write_png(self._path(fid, "left"), left)
                if right is not None:
                    write_png(self._path(fid, "right"), right)
                if disp is not None:
                    raw = np.ascontiguousarray(disp, np.float32).view(
                        np.uint8).reshape(*disp.shape, 4)
                    write_png(self._path(fid, "disp"), raw)
            except (OSError, ValueError) as e:
                self.error = e

    def close(self):
        """Write what is queued, then stop; raises the first write error."""
        self._q.put(None)
        self._thread.join(timeout=60.0)
        if self.error is not None:
            raise self.error


def record(frames, out_dir: str, with_disp=True):
    """Write each frame dict (float [0, 1] 'left', optional 'right',
    'disp_gt' or 'disp') as the reference's dump; returns the count."""
    w = FileWriter(out_dir)
    n = 0
    try:
        for f in frames:
            left = (_host(f["left"]) * 255).astype(np.uint8)
            right = ((_host(f["right"]) * 255).astype(np.uint8)
                     if "right" in f else None)
            disp = (_host(f.get("disp_gt", f.get("disp"))).astype(np.float32)
                    if with_disp else None)
            w.push(f.get("frame_id", n), left, right, disp)
            n += 1
    finally:
        w.close()
    return n


def record_live(grabber, out_dir: str, n_frames: int,
                timeout: float = 60.0) -> int:
    """Record from a polled RgbdGrabber: poll the latest-value monitor and
    hand each new frame to the background FileWriter. Frames arriving
    between polls are dropped by the grabber; frame ids are assigned at
    record time."""
    import time

    w = FileWriter(out_dir)
    n = 0
    t0 = time.time()
    try:
        while n < n_frames and time.time() - t0 < timeout:
            f = grabber.getFrame()
            if f is None:
                time.sleep(0.002)
                continue
            rgb, disp = f
            left = (rgb if rgb.dtype == np.uint8
                    else (np.clip(rgb, 0, 1) * 255 + 0.5).astype(np.uint8))
            w.push(n, left, None, np.asarray(disp, np.float32))
            n += 1
    finally:
        w.close()
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("out_dir")
    ap.add_argument("n_frames", nargs="?", type=int, default=60)
    ap.add_argument("--step", type=float, default=0.02)
    ap.add_argument("--config", help="reference-format .cfg (camera)")
    ap.add_argument("--source", default="synthetic",
                    help="synthetic (render straight to disk) | live (poll "
                         "an RgbdGrabber fed by a synthetic camera) | "
                         "dir:PATH (re-record a dump replayed as a live "
                         "source)")
    ap.add_argument("--fps", type=float, default=30.0,
                    help="live-source capture rate (frames between polls "
                         "are dropped)")
    ap.add_argument("--device", default=None,
                    help="device the synthetic source renders on (default: "
                         "the CUDA card; 'cpu' to run without one)")
    args = ap.parse_args(argv)

    if args.config:
        from scavislam_tpu_torch.utils.config import load_config

        cfg = load_config(args.config)
    else:
        cfg = Config()
    cam = build_camera(cfg)

    if args.source == "synthetic":
        from scavislam_tpu_torch.io.synthetic import SyntheticSequence

        seq = SyntheticSequence(cam, n_frames=args.n_frames, step=args.step,
                                device=args.device)
        n = record(iter(seq), args.out_dir)
    elif args.source == "live" or args.source.startswith("dir:"):
        from scavislam_tpu_torch.io.rgbd_grabber import (
            RgbdGrabber,
            directory_source,
        )

        if args.source == "live":
            from scavislam_tpu_torch.io.synthetic import SyntheticSequence

            seq = SyntheticSequence(cam, n_frames=args.n_frames,
                                    step=args.step, device=args.device)
            state = {"i": 0}

            def camera():
                i = state["i"]
                if i >= args.n_frames:
                    return None  # a real camera never ends the stream
                f = seq.frame(i)
                state["i"] += 1
                left = (np.clip(_host(f["left"]), 0, 1) * 255
                        + 0.5).astype(np.uint8)
                return left, _host(f["disp_gt"]).astype(np.float32)

            source = camera
        else:
            source = directory_source(args.source[4:])
        grabber = RgbdGrabber()
        grabber.start(source, fps=args.fps)
        try:
            n = record_live(grabber, args.out_dir, args.n_frames)
        finally:
            grabber.stop()
    else:
        ap.error(f"unknown --source {args.source!r}")
    print(f"wrote {n} frames to {args.out_dir}")


if __name__ == "__main__":
    main()

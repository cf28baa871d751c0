"""Headless stereo / RGB-D SLAM command line (port of
scavislam_tpu.apps.stereo_slam).

Runs the whole system (frontend + DWO backend + place recognition) over a
disk sequence (a New College-layout PNM tree, an RGB-D dump, any tree the
config's framepipe keys describe) or a synthetic sequence, exports the
trajectory and prints a JSON summary: the per-stage timings, frames,
keyframes, map points, closed loops, the frame loop's rate and its wait on
the grabber, and the ATE when ground truth is known.

Usage:
  python -m scavislam_tpu_torch.apps.stereo_slam <config.cfg> [options]
  python -m scavislam_tpu_torch.apps.stereo_slam --synthetic 100 [options]

The config file is the reference's format. Everything runs on the CUDA card
unless ``--device cpu`` is given. With ``--pipelined`` the grabber copies
each frame onto the card from its own thread (``device_prefetch``).
``--save-map``, ``--save-system``, ``--load-system`` and ``--save-traj-tum``
go through utils/serialization.py. The viewers stand in for the reference's
GUI: ``--viz`` (top-down map PNG), ``--viz-html`` (the interactive 3-D map,
apps/map3d.py), ``--debug-mode`` (every Nth frame's debug view),
``--timing-plot``, ``--keyframe-view`` (apps/visualize.py) and ``--watch``
(live artifacts and live tunables, apps/watch.py). ``--streams N
--streams-mesh M`` shards N synthetic streams over M cards
(parallel/multistream.make_mesh; on the CPU, M copies of the CPU device).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from scavislam_tpu_torch import resolve_device
from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.utils.config import Config, load_config

def build_camera(cfg: Config) -> StereoCamera:
    return StereoCamera.create(
        cfg.cam.f, (cfg.cam.px, cfg.cam.py),
        (cfg.cam.width, cfg.cam.height), cfg.cam.baseline,
    )


def _u8(x: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(x, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def run_streams(args, cfg: Config, cam: StereoCamera, device):
    """N concurrent synthetic streams through one batched frame step per
    tick (parallel.stream_pool.StreamPool): stream 0 tracks default_room(),
    stream s > 0 varied_box(s), each on the forward arc. Prints one JSON
    summary (aggregate frames/s, per-stream ATE and keyframes) and writes
    one trajectory file per stream next to --out."""
    import os

    from scavislam_tpu_torch.io.synthetic import (
        SyntheticSequence,
        default_room,
        varied_box,
    )
    from scavislam_tpu_torch.parallel.stream_pool import StreamPool
    from scavislam_tpu_torch.pipeline.slam_system import ate_rmse

    B = args.streams
    n = args.synthetic or 60
    if not args.synthetic:
        print("--streams drives synthetic sequences; "
              f"defaulting to --synthetic {n}", file=sys.stderr)
    mesh = None
    if args.streams_mesh != 0:
        ncards = torch.cuda.device_count() if device.type == "cuda" else 1
        want = args.streams_mesh if args.streams_mesh > 0 else ncards
        if want > 1 and B % want == 0:
            from scavislam_tpu_torch.parallel.multistream import make_mesh

            # pure data parallel (sp = 1); off the card, the CPU device
            # stands in for each member of the mesh
            mesh = make_mesh(want, dp=want, devices=(
                None if device.type == "cuda" else [device] * want))

    # render every stream's frames to uint8 once, before timing
    seqs = [
        SyntheticSequence(
            cam, n_frames=n, step=args.synthetic_step,
            planes=default_room() if s == 0 else varied_box(s),
            device=device)
        for s in range(B)
    ]
    gt = [[] for _ in range(B)]
    frames_u8 = []  # [i][s] -> frame dict
    for i in range(n):
        tick = []
        for s in range(B):
            f = seqs[s].frame(i)
            gt[s].append(f["T_cw_gt"])
            tick.append({"frame_id": i, "left": _u8(f["left"]),
                         "right": _u8(f["right"])})
        frames_u8.append(tick)

    pool = StreamPool(cam, cfg, n_streams=B, mesh=mesh,
                      pipeline_depth=args.pipeline_depth or 2, device=device)
    pool.process_first_frames(frames_u8[0])
    # warm the remaining programs (consume path + spawn) before timing
    warm = min(4, n - 1)
    for i in range(1, 1 + warm):
        pool.process_frames(frames_u8[i])
    t0 = time.perf_counter()
    for i in range(1 + warm, n):
        pool.process_frames(frames_u8[i])
    pool.finish()
    dt = time.perf_counter() - t0
    timed = max(n - 1 - warm, 1)

    stem, ext = os.path.splitext(args.out)
    per_stream = []
    for s in range(B):
        traj = pool.trajectories[s]
        rows = [np.concatenate([[fid], T.t, np.asarray(T.log())[3:]])
                for fid, T in traj]
        np.savetxt(f"{stem}_s{s}{ext or '.txt'}", np.asarray(rows))
        pairs = [(fid, T) for fid, T in traj if 0 <= int(fid) < n]
        ate = ate_rmse(pairs, [gt[s][int(fid)] for fid, _ in pairs])
        per_stream.append({
            "stream": s,
            "alive": bool(pool.alive[s]),
            "frames": len(traj),
            "keyframes": int(pool.fes[s].next_kf),
            "ate_rmse_m": round(float(ate), 5),
        })

    summary = {
        "streams": B,
        "mesh": None if mesh is None else dict(mesh.shape),
        "frames_per_stream": n,
        "aggregate_fps": round(B * timed / dt, 1),
        "per_stream_fps": round(timed / dt, 1),
        "per_stream": per_stream,
    }
    print(json.dumps(summary, indent=2))
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config", nargs="?", help="reference-format .cfg file")
    ap.add_argument("--dataset", help="override framepipe.path_str")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="run N synthetic frames instead of a dataset")
    ap.add_argument("--synthetic-step", type=float, default=0.02)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--out", default="trajectory.txt")
    ap.add_argument("--no-loop-closure", action="store_true")
    ap.add_argument("--threaded", action="store_true",
                    help="run the backend and place recognition in their "
                         "own threads (the reference's topology)")
    ap.add_argument("--vocabulary", help=".npz vocabulary (key 'vocab')")
    ap.add_argument("--pipelined", action="store_true",
                    help="pipelined frame processing (the keyframe policy "
                         "lags the dispatch); also prefetches frames to the "
                         "card")
    ap.add_argument("--pipeline-depth", type=int, default=None,
                    help="frames in flight when pipelined (default 2)")
    ap.add_argument("--streams", type=int, default=0,
                    help="run N concurrent synthetic streams through one "
                         "batched frame step per tick")
    ap.add_argument("--streams-mesh", type=int, default=-1,
                    help="shard the stream batch over a dp-mesh of this "
                         "many cards (-1: every card when the streams divide "
                         "evenly; 0: one card)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "without one)")
    ap.add_argument("--save-map", help="save the final SLAM graph to .npz")
    ap.add_argument("--save-system",
                    help="checkpoint the full system (graph + frontend "
                         "tables + BoW index) for resume / map reuse")
    ap.add_argument("--load-system",
                    help="start from a saved system checkpoint; begins in "
                         "lost mode and relocalizes against the loaded map")
    ap.add_argument("--save-traj-tum", help="export the trajectory in TUM "
                                            "format")
    ap.add_argument("--viz", help="render a top-down map PNG at the end")
    ap.add_argument("--viz-html",
                    help="export the interactive 3-D map viewer (one "
                         "self-contained HTML file) at the end")
    ap.add_argument("--debug-mode", type=int, default=-1,
                    help="0-6: per-frame debug view PNGs (residual/cur/prev/"
                         "dx/dy/right/color-disp, the GUI's ui.debug)")
    ap.add_argument("--debug-level", type=int, default=0,
                    help="pyramid level for --debug-mode (ui.debug_level)")
    ap.add_argument("--debug-out", default="debug_frames",
                    help="directory for --debug-mode PNGs")
    ap.add_argument("--debug-every", type=int, default=10,
                    help="write every Nth frame's debug view")
    ap.add_argument("--timing-plot",
                    help="stacked per-stage timing histogram PNG (the GUI's "
                         "live plotter)")
    ap.add_argument("--keyframe-view",
                    help="PNG of the last keyframe's image + anchored points "
                         "(the GUI's ui.show_keyframe view)")
    ap.add_argument("--watch", metavar="DIR",
                    help="live observability: refresh map/debug/timing PNGs "
                         "+ status.json in DIR and re-read DIR/tunables.cfg "
                         "while running (the headless analogue of the "
                         "reference's Pangolin GUI + Vars)")
    ap.add_argument("--watch-period", type=float, default=1.0,
                    help="watch refresh period in seconds (also live-tunable)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = load_config(args.config) if args.config else Config()
    cam = build_camera(cfg)

    if args.streams:
        return run_streams(args, cfg, cam, device)

    from scavislam_tpu_torch.pipeline.slam_system import SlamSystem, ate_rmse

    if args.load_system:
        from scavislam_tpu_torch.utils.serialization import load_system

        system = load_system(
            args.load_system, cam, cfg, threaded=args.threaded,
            enable_loop_closure=not args.no_loop_closure,
            pipelined=args.pipelined, pipeline_depth=args.pipeline_depth,
            device=device)
    else:
        vocab = (np.load(args.vocabulary)["vocab"] if args.vocabulary
                 else None)
        system = SlamSystem(
            cam, cfg, threaded=args.threaded,
            enable_loop_closure=not args.no_loop_closure,
            vocabulary=vocab, pipelined=args.pipelined,
            pipeline_depth=args.pipeline_depth, device=device,
        )

    grabber = None
    if args.synthetic:
        from scavislam_tpu_torch.io.synthetic import SyntheticSequence

        frames = iter(SyntheticSequence(cam, n_frames=args.synthetic,
                                        step=args.synthetic_step,
                                        device=device))
    else:
        from scavislam_tpu_torch.io.filegrabber import FileGrabber

        grabber = FileGrabber(
            args.dataset or cfg.framepipe.path_str,
            base_pattern=cfg.framepipe.base_str,
            fmt=cfg.framepipe.format_str,
            right_img=cfg.framepipe.right_img,
            disp_img=cfg.framepipe.disp_img,
            depth_img=cfg.framepipe.depth_img,
            skip=cfg.framepipe.skip_imgs,
            focal=cfg.cam.f,
            baseline=cfg.cam.baseline,
            device_prefetch=args.pipelined,
            device=device,
        )
        frames = iter(grabber)
    if args.keyframe_view:
        # the keyframe view reads stored keyframe pyramids; retention is
        # off by default (device memory on long runs)
        system.frontend.keep_kf_images = True
    try:
        n, loop_s, wait_s, gt_poses = _frame_loop(
            system, frames, args.max_frames, device,
            _live_viewers(args, cfg, system))
        system.finish()
    finally:
        if grabber is not None:
            grabber.close()
        system.shutdown()
    traj = system.export_trajectory()
    np.savetxt(args.out, traj)
    _save_outputs(args, system)
    _final_views(args, system, gt_poses)

    summary = system.per_mon.summary()
    summary["frames_processed"] = n
    summary["keyframes"] = len(system.frontend.keyframe_map)
    summary["map_points"] = int(system.frontend.points.valid.sum())
    summary["closed_loops"] = len(system.closed_loops)
    timed = max(n - 2, 0)
    summary["frames_per_s"] = timed / loop_s if loop_s > 0 else None
    summary["grab_wait_ms"] = 1e3 * wait_s / timed if timed else None
    if gt_poses:
        pairs = [(fid, T) for fid, T in system.trajectory
                 if 0 <= int(fid) < len(gt_poses)]
        summary["ate_rmse_m"] = ate_rmse(
            pairs, [gt_poses[int(fid)] for fid, _ in pairs])
    print(json.dumps(summary, indent=2))
    return summary


def _save_outputs(args, system):
    """The checkpoint and export flags (utils/serialization.py)."""
    from scavislam_tpu_torch.utils import serialization

    if args.save_traj_tum:
        serialization.save_trajectory_tum(system.trajectory,
                                          args.save_traj_tum)
    if args.save_map:
        serialization.save_graph(system.backend.graph, args.save_map)
    if args.save_system:
        serialization.save_system(system, args.save_system)


def _live_viewers(args, cfg, system):
    """The per-frame viewers (--watch, --debug-mode) as one callable
    after(n, gt_poses) -> True when the watcher asks to quit; None when
    neither flag is given."""
    import os

    num_disp = 16 * cfg.ui.num_disp16
    watcher = None
    if args.watch:
        from scavislam_tpu_torch.apps.watch import Watcher

        watcher = Watcher(args.watch, system, period=args.watch_period,
                          num_disp=num_disp,
                          debug_mode=max(args.debug_mode, 0))
    if args.debug_mode >= 0:
        os.makedirs(args.debug_out, exist_ok=True)
    if watcher is None and args.debug_mode < 0:
        return None

    def after(n, gt_poses):
        if watcher is not None:
            watcher.tick(n, gt_poses)
            if watcher.quit:
                print("watch: quit requested", file=sys.stderr)
                return True
        if args.debug_mode >= 0 and n % max(args.debug_every, 1) == 0:
            from scavislam_tpu_torch.apps.visualize import render_debug_image

            render_debug_image(args.debug_mode, args.debug_level,
                               system.frontend, num_disp=num_disp,
                               path=f"{args.debug_out}/debug_{n:06d}.png")
        return False

    return after


def _final_views(args, system, gt_poses):
    """The end-of-run viewers: --viz, --viz-html, --timing-plot and
    --keyframe-view (the last keyframe)."""
    from scavislam_tpu_torch.apps import visualize

    if args.viz:
        visualize.render_map_topdown(
            system.backend.graph, trajectory=system.trajectory,
            gt_poses=gt_poses or None, path=args.viz)
    if args.viz_html:
        from scavislam_tpu_torch.apps.map3d import export_map_html

        export_map_html(
            system.backend.graph, trajectory=system.trajectory,
            gt_poses=gt_poses or None, path=args.viz_html,
            actkey_id=system.frontend.actkey_id)
    if args.timing_plot:
        visualize.render_timing_plot(system.per_mon, path=args.timing_plot)
    if args.keyframe_view and system.frontend.keyframe_map:
        visualize.render_keyframe_view(
            system.frontend, max(system.frontend.keyframe_map),
            path=args.keyframe_view)


def _frame_loop(system, frames, max_frames, device, after=None):
    """Feed `frames` to `system` until they end, `max_frames` were fed,
    tracking fails or `after(n, gt_poses)` (called after each frame) asks
    to stop. Returns (frames fed, seconds and grabber wait over frames 2..
    to the frontend's flush, ground-truth poses seen)."""
    n, wait_s, t_start, gt_poses = 0, 0.0, None, []
    while True:
        t0 = time.perf_counter()
        frame = next(frames, None)
        if frame is None or (max_frames and n >= max_frames):
            break
        if t_start is not None:
            wait_s += time.perf_counter() - t0
        if "T_cw_gt" in frame:
            gt_poses.append(frame["T_cw_gt"])
        if n == 0:
            system.process_first_frame(frame)
        elif not system.process_frame(frame):
            print("FAILURE! tracking lost at frame", n, file=sys.stderr)
            break
        if after is not None and after(n, gt_poses):
            break
        n += 1
        if n == 2:
            _sync(device)
            t_start = time.perf_counter()
    system._flush_frontend()
    _sync(device)
    loop_s = time.perf_counter() - t_start if t_start is not None else 0.0
    return n, loop_s, wait_s, gt_poses


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


if __name__ == "__main__":
    main()

"""Monocular visual odometry command line (port of
scavislam_tpu.apps.mono_vo): the mono mode the reference scaffolds but
never ships (``#ifdef MONO``, README:14-15).

Runs models.mono_frontend.MonoFrontend over the LEFT image stream of a
disk sequence or a synthetic sequence, with optional Sim3 loop closure
between revisiting keyframes (models.mono_loop) and window BA. Mono
trajectories are scale-gauged by the inverse-depth prior: against ground
truth the summary gives the Sim3-aligned ATE.

Usage:
  python -m scavislam_tpu_torch.apps.mono_vo --synthetic 40 --loop-close
  python -m scavislam_tpu_torch.apps.mono_vo data/newcollege.cfg --out t.txt

Everything runs on the CUDA card unless ``--device cpu`` is given. With
``--pipelined`` the frames reach the card ahead of the tracking loop: a
dataset through the grabber's device prefetch, a synthetic sequence by an
upload of each frame's uint8 left plane a few frames ahead. The viewers:
``--viz`` (top-down map PNG, apps/visualize.py), ``--viz-html`` (the
interactive 3-D map, apps/map3d.py) and ``--watch DIR`` (map3d.html and
status.json refreshed every ``--watch-period`` seconds).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import types
from collections import deque

import numpy as np
import torch

from scavislam_tpu_torch import resolve_device
from scavislam_tpu_torch.models.frontend import _to_u8

def _scene_graph(fe, with_points: bool = False):
    """Graph-shaped view of a MonoFrontend for the viewers (apps/visualize
    and apps/map3d read .vertices / .points / .edges); the points are the
    converged ones, downloaded once."""
    verts = {k: types.SimpleNamespace(R=v[0], t=v[1])
             for k, v in fe.pose_np.items()}
    pts = {}
    if with_points:
        lam = fe.Lam[:, 2, 2].cpu().numpy()
        anch = fe._meta_anchor
        psi = fe.points.psi.cpu().numpy()
        for pid in np.nonzero((anch >= 0) & (lam > fe.conv_q_info))[0]:
            pts[int(pid)] = types.SimpleNamespace(
                anchor_id=int(anch[pid]), psi=psi[pid])
    return types.SimpleNamespace(vertices=verts, points=pts, edges={})


def _upload_ahead(frames, device, depth=4):
    """Put each frame's left plane on `device` as uint8 (``left_dev``)
    `depth` frames ahead of the tracking loop: the synthetic path's
    counterpart of the grabber's device prefetch. The uint8 quantization
    makes a pipelined synthetic run differ from an unpipelined f32 run by
    up to 1/510 per pixel."""
    pending = deque()
    for f in frames:
        if "left_dev" not in f:
            f["left_dev"] = torch.as_tensor(_to_u8(f["left"])).to(
                device, non_blocking=True)
        pending.append(f)
        if len(pending) > depth:
            yield pending.popleft()
    while pending:
        yield pending.popleft()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config", nargs="?", help="reference-format .cfg file")
    ap.add_argument("--dataset", help="override framepipe.path_str")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="run N synthetic frames instead of a dataset")
    ap.add_argument("--synthetic-kind", default="forward_arc")
    ap.add_argument("--synthetic-step", type=float, default=0.035)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--out", default=None, help="trajectory export (TUM)")
    ap.add_argument("--prior-idepth", type=float, default=0.25,
                    help="inverse-depth prior = the global scale gauge")
    ap.add_argument("--loop-close", action="store_true",
                    help="live BoW loop detection (per new keyframe) + Sim3 "
                         "closure, plus a final last-vs-first check")
    ap.add_argument("--loop-score-thr", type=float, default=None,
                    help="BoW acceptance score (default: the reference "
                         "operating point 2.0)")
    ap.add_argument("--vocabulary", help=".npz vocabulary (key 'vocab')")
    ap.add_argument("--save-system",
                    help="checkpoint the full mono state to .npz at the end")
    ap.add_argument("--load-system",
                    help="resume from a mono checkpoint (tracking continues "
                         "from the checkpointed pose and map)")
    ap.add_argument("--window-ba", action="store_true",
                    help="joint pose+structure window BA at every new "
                         "keyframe")
    ap.add_argument("--dwo", action="store_true",
                    help="with --window-ba: the covisibility double window "
                         "(inner keyframes get point BA, outer keyframes "
                         "are held by frozen marginalized constraints)")
    ap.add_argument("--dwo-inner", type=int, default=5,
                    help="inner-window size for --dwo")
    ap.add_argument("--dwo-outer", type=int, default=16,
                    help="outer-window size for --dwo")
    ap.add_argument("--pipelined", action="store_true",
                    help="overlapped frame loop (the policy lags the "
                         "dispatch by the pipeline depth); frames go to the "
                         "card ahead of the loop")
    ap.add_argument("--pipeline-depth", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "without one)")
    ap.add_argument("--viz", help="top-down map PNG at the end")
    ap.add_argument("--viz-html",
                    help="interactive 3-D map HTML at the end")
    ap.add_argument("--watch", metavar="DIR",
                    help="refresh DIR/map3d.html and DIR/status.json while "
                         "running")
    ap.add_argument("--watch-period", type=float, default=1.0)
    args = ap.parse_args(argv)

    from scavislam_tpu_torch.core.camera import StereoCamera
    from scavislam_tpu_torch.models import mono_loop
    from scavislam_tpu_torch.models.mono_frontend import MonoFrontend
    from scavislam_tpu_torch.utils.config import Config, load_config

    device = resolve_device(args.device)
    cfg = load_config(args.config) if args.config else Config()
    cam = StereoCamera.create(cfg.cam.f, (cfg.cam.px, cfg.cam.py),
                              (cfg.cam.width, cfg.cam.height),
                              cfg.cam.baseline)

    gt_poses = []
    grabber = None
    if args.synthetic:
        from scavislam_tpu_torch.io.synthetic import SyntheticSequence

        seq = SyntheticSequence(cam, n_frames=args.synthetic,
                                kind=args.synthetic_kind,
                                step=args.synthetic_step, device=device)
        frames = iter(seq)
        if args.pipelined:
            frames = _upload_ahead(frames, device,
                                   depth=max(4, args.pipeline_depth or 0))
    else:
        from scavislam_tpu_torch.io.filegrabber import FileGrabber

        grabber = FileGrabber(
            args.dataset or cfg.framepipe.path_str,
            base_pattern=cfg.framepipe.base_str,
            fmt=cfg.framepipe.format_str,
            right_img=False,  # mono consumes only the left stream
            skip=cfg.framepipe.skip_imgs,
            focal=cfg.cam.f,
            baseline=cfg.cam.baseline,
            device_prefetch=args.pipelined,
            device=device,
        )
        frames = iter(grabber)

    if args.load_system:
        from scavislam_tpu_torch.utils.serialization import load_mono_system

        fe = load_mono_system(args.load_system, cam, cfg, device=device)
    else:
        fe = MonoFrontend(cam, cfg, prior_idepth=args.prior_idepth,
                          device=device)
    if args.pipeline_depth:
        fe.pipeline_depth = args.pipeline_depth
    detector = None
    loops_closed = []
    if args.loop_close:
        vocab = (np.load(args.vocabulary)["vocab"] if args.vocabulary
                 else None)
        detector = mono_loop.make_mono_place_recognizer(
            fe, vocab, score_thr=args.loop_score_thr)

    def on_keyframe(kf_id, img):
        if args.window_ba:
            # pipelined runs dispatch the solve and adopt it at a later
            # frame; synchronous runs solve inline
            fe.window_ba(window=args.dwo_inner if args.dwo else 5,
                         sync=not args.pipelined, dwo=args.dwo,
                         outer=args.dwo_outer)
        if detector is not None:
            index_keyframe(kf_id, img)

    def index_keyframe(kf_id, img):
        det = mono_loop.add_keyframe_to_recognizer(detector, fe, kf_id, img)
        if det is not None:
            scales = mono_loop.close_loop_sim3(
                fe, det.query_id, det.loop_id, det.S_query_from_loop)
            loops_closed.append({
                "query": det.query_id, "loop": det.loop_id,
                "inliers": det.inliers,
                "scale": round(float(det.S_query_from_loop.s), 4),
                "regauge": round(scales[det.query_id], 4),
            })

    watch_state = None
    if args.watch:
        os.makedirs(args.watch, exist_ok=True)
        watch_state = {"dir": args.watch, "last": 0.0,
                       "period": args.watch_period}

    def watch_tick(n):
        now = time.monotonic()
        if now - watch_state["last"] < watch_state["period"]:
            return
        watch_state["last"] = now
        from scavislam_tpu_torch.apps.map3d import export_map_html

        try:
            export_map_html(_scene_graph(fe), trajectory=fe.trajectory,
                            gt_poses=gt_poses or None,
                            path=os.path.join(watch_state["dir"],
                                              "map3d.html"),
                            actkey_id=fe.actkey_id)
            tmp = os.path.join(watch_state["dir"], "status.json.tmp")
            with open(tmp, "w") as f:
                json.dump({"frame": n, "keyframes": fe.next_kf,
                           "lost": lost, "relocalizations": relocs}, f)
            os.replace(tmp, os.path.join(watch_state["dir"], "status.json"))
        except Exception as e:  # watching never stops the run
            print(f"watch: refresh failed: {type(e).__name__}: {e}",
                  file=sys.stderr)

    t0 = time.perf_counter()
    n = 0
    lost = False
    relocs = 0
    try:
        for frame in frames:
            if args.max_frames and n >= args.max_frames:
                break
            if "T_cw_gt" in frame:
                gt_poses.append(frame["T_cw_gt"])
            if n == 0 and not args.load_system:
                fe.process_first_frame(frame)
                if detector is not None:
                    index_keyframe(fe.actkey_id, frame["left"])
            elif lost:
                if detector is not None and fe.relocalize(detector, frame):
                    lost = False
                    relocs += 1
            elif args.pipelined:
                r = fe.process_frame_pipelined(frame)
                if r is not None:
                    ok, dropped, _fid = r
                    if not ok:
                        if detector is not None:
                            print(f"mono tracking lost near frame {n}; "
                                  "relocalizing", file=sys.stderr)
                            lost = True
                            n += 1
                            continue
                        print(f"mono tracking FAILED near frame {n}",
                              file=sys.stderr)
                        break
                    if dropped:
                        on_keyframe(fe.actkey_id, fe.last_kf_img)
            else:
                ok, dropped = fe.process_frame(frame)
                if not ok:
                    if detector is not None:
                        # lost mode: keep consuming frames and relocalize
                        print(f"mono tracking lost at frame {n}; "
                              "relocalizing", file=sys.stderr)
                        lost = True
                        n += 1
                        continue
                    print(f"mono tracking FAILED at frame {n}",
                          file=sys.stderr)
                    break
                if dropped:
                    on_keyframe(fe.actkey_id, frame["left"])
            if watch_state is not None:
                watch_tick(n)
            n += 1
        if args.pipelined:
            for ok, dropped, _fid in fe.flush_pipeline():
                if dropped:
                    on_keyframe(fe.actkey_id, fe.last_kf_img)
            # a window solve dispatched near the end would otherwise be
            # dropped: the summary and the checkpoint must reflect it
            fe.adopt_pending_ba(force=True)
    finally:
        if grabber is not None:
            grabber.close()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    loop_report = None
    if detector is not None:
        loop_report = {"closed": loops_closed}
        if not loops_closed and fe.next_kf >= 2:
            # final check: the last keyframe against the first
            kf_last = max(fe.pose_np)
            S, n_inl = mono_loop.estimate_sim3(fe, kf_last, 0)
            if S is not None:
                scales = mono_loop.close_loop_sim3(fe, kf_last, 0, S)
                loop_report["final_check"] = {
                    "inliers": n_inl, "scale": round(float(S.s), 4),
                    "regauge": round(scales[kf_last], 4)}
            else:
                loop_report["final_check"] = {"inliers": n_inl,
                                              "accepted": False}

    lam_qq = fe.Lam[:, 2, 2].cpu().numpy()
    summary = {
        "frames": n,
        "fps": round(n / max(wall, 1e-9), 1),
        "keyframes": fe.next_kf,
        "points": int(fe.points.valid.sum()),
        "converged_points": int((lam_qq > fe.conv_q_info).sum()),
        "relocalizations": relocs,
    }
    if loop_report is not None:
        summary["loop"] = loop_report
    if gt_poses and len(fe.trajectory) > 3:
        from scavislam_tpu_torch.pipeline.slam_system import ate_rmse_aligned

        # pair by FRAME ID: a stale-epoch skip (pipelined) leaves a frame
        # out of the trajectory while gt_poses still has it
        paired = [(fid, T) for fid, T in fe.trajectory
                  if 0 <= fid < len(gt_poses)]
        summary["ate_sim3_m"] = round(
            ate_rmse_aligned(paired, [gt_poses[fid] for fid, _T in paired]),
            5)

    if args.save_system:
        from scavislam_tpu_torch.utils.serialization import save_mono_system

        save_mono_system(fe, args.save_system)
    if args.out:
        from scavislam_tpu_torch.utils.serialization import (
            save_trajectory_tum,
        )

        save_trajectory_tum(fe.trajectory, args.out)
    if args.viz or args.viz_html:
        graph = _scene_graph(fe, with_points=True)
        if args.viz:
            from scavislam_tpu_torch.apps.visualize import render_map_topdown

            render_map_topdown(graph, trajectory=fe.trajectory,
                               gt_poses=gt_poses or None, path=args.viz)
        if args.viz_html:
            from scavislam_tpu_torch.apps.map3d import export_map_html

            export_map_html(graph, trajectory=fe.trajectory,
                            gt_poses=gt_poses or None, path=args.viz_html,
                            actkey_id=fe.actkey_id)
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()

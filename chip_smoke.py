"""Drive the PyTorch port's paths once on one CUDA card: the synchronous
and pipelined single-stream frontend (its frame step a CUDA graph
replay), the 8-stream pool, the whole
SlamSystem (frontend + backend + place recognition) as the headline
benchmark configures it, the loop-closure workload and relocalization, the
disk entry point, the stereo methods, the monocular mode, the viewers, the
vocabulary trainer and the device mesh.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each prints its numbers on its own line; any failure exits
non-zero before the result line):

1. device  — a CUDA card must be present (there is no CPU fallback); the
   card's name and power limit as nvidia-smi reports them;
2. build   — the block-matching kernels (bm_cost_kernel, bm_lr_kernel)
   and the dense tracker's evaluation (dense_ic_partial_kernel,
   dense_ic_final_kernel) are compiled from the checkout's sources
   (scavislam_tpu_torch/csrc/{stereo_bm,dense_ic}.cu -> build/kernels/);
   ptxas's registers, shared memory and spills of each (a spill fails);
3. kernel  — the CUDA kernels against their plain PyTorch version on one
   rendered 512x384 pair at 64 disparities: the output must be torch.equal
   to the plain version's and within 0.5 px of ground truth (median); the
   median time of each over 25 runs (CUDA events) beside the kernels'
   bound (the ops the algorithm needs at the card's fp32 peak, or its
   bytes at the memory rate, whichever is longer) and the share of it
   reached;
4. slice   — StereoFrontend with Config() defaults (512x384, stereo method
   2) on the wander-in-closed-box workload at step 0.06, 80 frames: frames/s,
   keyframes, ATE against ground truth and the kernel's launch count, which
   must equal the frames stepped; every frame must track, >= 2 keyframes,
   ATE < 0.05 m; the dense evaluation's launches per step replay
   (phase 17);
5. batched — frame 0 of 8 scenes at 512x384 (stream 0 closed_box(), streams
   1-7 varied_box(s)), binomial3-smoothed and Sobel-prefiltered: the batched
   kernel must equal (torch.equal) its plain version and the single-image
   kernel per stream; median ms of 25 runs of the batched kernel, the plain
   batched version and 8 single-image launches, the batched time beside its
   bound and the share of it reached;
6. pipelined — StereoFrontend.process_frame_pipelined at depth 2 then
   flush_pipeline on phase 4's frames: frames/s beside phase 4's, the
   timing-log split (dispatch / fetch wait / consume); every frame tracked,
   >= 2 keyframes, ATE < 0.05 m, one single-image launch per frame;
7. pool    — StreamPool(8 streams, Config() defaults, depth 2), each stream
   on its phase-5 scene along the wander at step 0.06, 512x384, 24 ticks:
   aggregate frames/s, ms per tick and its split, keyframes per stream;
   every stream alive with 24 trajectory entries, >= 2 keyframes and
   ATE < 0.05 m each; one batched launch per tick dispatched and no
   single-image launch; the tick's program (prefilter, batched kernel,
   vmapped step) one CUDA graph: one capture at tick 0 and one replay per
   later tick; no synchronizing call that sync debug mode "warn" sees on
   a tick but SPAWN_SYNCS per keyframe decided on it (the tick's one
   wait, on the packed fetch's CUDA event, it does not see); the dense
   evaluation's launches per tick replay (phase 17). (b) From the
   state at tick 12, one replay of the batched program held lane by lane
   against each stream's single-stream step replayed by a StepGraph (the
   programs round differently): counts, matches and gates equal, the
   pose within 1e-6 and the observations within 2e-4 px plus 1e-6
   relative (the CPU tests' bars), or within twice the single-stream
   replay's own move over 16 one-ulp moves of its f32 state where that is
   larger; the maxima, bars and moves printed; ms per batched replay
   against 8 single replays;
8. system  — SlamSystem(threaded, pipelined at depth 3, loop closure off,
   Config() defaults) on phase 4's 80 frames after one warm-up run:
   frames/s over frames 2..79, keyframes, graph vertices, solves adopted and
   their median device ms (dispatch event to download event), the
   backend's counters, neighborhoods adopted, ATE and kernel launches;
   every frame tracked, vertices == keyframes after finish(), a solve
   adopted with chi2_final <= chi2_init, ATE < 0.05 m, one single-image
   launch per frame. Then the same run with loop closure on (the twin's
   default; pr_lossless), after its own warm-up run: the same checks, the
   recognizer indexed every keyframe, each from its keyframe's pr_packed
   block (no describe on the recognizer's thread), and its frames/s beside
   the loop-closure-off run's. Then the same frames unthreaded and
   synchronous (the deterministic mode, loop closure off) with the same
   numbers and checks. Last, solve_ba
   alone on the threaded run's last packed problem at the full capacities
   (P, L, O, E) = (128, 2048, 8192, 512), captured as a CUDA graph: median
   of 25 replays with CUDA events, and each stage of one LM round (normal
   equations, Schur product, Cholesky plus back-substitution) the same
   way; the eager call's wall time beside.
9. loop    — benchmarks/run_configs.py config 2 through the port: the
   256x192 camera, the 90-frame 360-degree spin in closed_box() (step
   1/89), covis_thr 10, parallax_thr 0.25, windows 3 + 8, SlamSystem
   threaded, pipelined at depth 3, loop closure on with pr_lossless, after
   place_recognizer.warmup() and a warm-up run: frames/s, the recognizer's
   and the backend's glc_* counters, loops, METRIC and APPEARANCE edges,
   ATE (beside them, unchecked: the same run with loop closure off and the
   pipelined frontend alone); at least 88 of 90 frames tracked, the graph reconnected (an
   APPEARANCE or METRIC edge between keyframes more than 4 apart, or a
   closed loop), ATE < 0.1 m, one single-image launch per frame. Then,
   with CUDA events over 25 runs: the keyframe spawn step with and without
   the vocabulary (the describe's cost per keyframe) and bow_describe
   alone as a CUDA graph replay; the geometric check at the 256-key
   capacity as a graph replay, and its wall time with its upload and
   download; it must enqueue with no synchronizing call
   (torch.cuda.set_sync_debug_mode("error")); one relocalize call, wall
   time;
10. relocalize — tests/test_relocalization.py's kidnap on the card,
   unthreaded at 256x192 in the default room: 10 frames, 3 noise frames ->
   lost, frame 5 again -> one relocalization with position error < 0.25
   m, 3 more frames -> error < 0.08 m;
11. disk    — the disk-sequence entry point, in a temporary directory at
   512x384 with Config() defaults. (a) Phase 4's 80 frames written as a New
   College tree (P5 `...-rectified-{left,right}.pnm` over two segment
   directories, a reference-format .cfg) and run through
   `scavislam_tpu_torch.apps.stereo_slam.main([cfg, "--threaded",
   "--pipelined", "--pipeline-depth", "3"])` (loop closure on) after a
   12-frame warm-up run: 80/80 tracked, ATE < 0.05 m from the written
   trajectory file, >= 2 keyframes, one single-image launch per frame;
   frames/s beside phase 8's loop-closure-on run and the frame loop's wait
   on the grabber. (b) The grabber alone (native decode + prefetch to the
   card, no SLAM): frames/s, decode ms and upload ms (CUDA events) per
   frame; every stack as the frame step receives it torch.equal to the
   files' bytes. (c) The same 80 frames recorded as an RGB-D dump (left +
   exact float disparity) by apps/dump_sequence.record and replayed through
   the CLI (FileGrabber(disp_img=True, device_prefetch=True) into the
   threaded, pipelined SlamSystem): 80/80, ATE < 0.05 m, no block-matching
   launch. (d) Rectification: with zero distortion the rectified stack is
   torch.equal to its input; 40 frames distorted with k1 = -0.04, k2 = 0.01
   on both eyes (each distorted pixel samples the clean render at its
   undistorted coordinate, 5 fixed-point iterations) run with
   framepipe.rectify_frame on: 40/40, ATE < 0.05 m (beside it, unchecked,
   the same frames with rectify off); _rectify_stack's device ms (CUDA
   events, 25 runs).
12. stereo methods — belief propagation (stereo method 3) and
   constant-space BP (method 4), plain PyTorch with no kernel of their own.
   (a) On phase 3's frame-0 pair at 512x384, binomial3-smoothed as the
   frame step smooths it, D = 64: BP with (iters, levels) = (5, 4), what
   the frame step passes for Config()'s (4, 4), and CSBP with (4, 4, 4).
   Each output finite, (H, W), within [0, 64], its median error against
   ground truth on valid interior pixels <= 1 px (BP) and <= 1.5 px (CSBP,
   whole pixels); over 25 runs each the eager call's wall ms and its ms
   between CUDA events, the replay ms of the call captured as a CUDA graph
   (the device's own time), the peak memory the call allocates, and its
   bound: the bytes it must move at 3.35 TB/s (per round the data term and
   four messages read and four messages written, over every level), beside
   phase 3's block-matching time. (b) The same functions on a 256x192 crop
   on the card and on the CPU: BP within 1e-3 px on >= 99% of pixels, CSBP
   equal on >= 99%. (c) Phase 11's New College tree, 40 frames, with a .cfg
   that sets stereo_method 3, then one that sets 4, through stereo_slam.main
   threaded, pipelined at depth 3, loop closure on, after a 6-frame warm-up
   run: 40/40 tracked, >= 2 keyframes, ATE from the written trajectory
   < 0.1 m (BP) and < 0.2 m (CSBP: its whole-pixel disparities cost the
   tracker; it scores ~0.17 m here), no block-matching launch; frames/s
   beside phase 11 (a)'s.

13. mono — the monocular mode, with no block-matching launch. (a)
   benchmarks/run_configs.py config 6 through the port: Config(), 512x384,
   the forward arc at step 0.01, 120 frames, each left plane on the card
   as uint8, MonoFrontend pipelined at depth 3 after a warm-up run that
   also spawns: every frame in the trajectory, >= 2 keyframes, the
   Sim3-aligned ATE under 0.06 x the path length
   (tests/test_mono.py:88-97); frames/s; the frontend's step graph
   captured once and replayed at every other frame (its captures and
   replays printed; more than one capture fails); the eager mono_step on the run's
   last state (wall ms and ms between CUDA events, enqueued with no
   synchronizing call under sync debug mode "error") and the step
   captured as a CUDA graph (replay ms, replay torch.equal to the eager
   step); the synchronous first 20 frames against the pipelined run within
   test_pipelined_matches_sync's bar. (b) The frames as a New College tree
   through apps/mono_vo.main with --loop-close --window-ba --dwo
   --pipelined --save-system on frames 0-79 (all tracked, > 50 converged
   points, the ATE bar), then --load-system on frames 80-119: the resumed
   pose equal to an in-process resume from the same files within 1e-5
   (test_checkpoint_resume's tolerance), the ATE bar over both runs. (c)
   At the twin's 128x96 camera: the mono loop-closure scene
   (tests/test_mono.py:133-240: a loop detected, a 1.3x drift found by
   the Sim3, close_loop_sim3 re-gauging it) and the kidnap (:412-452,
   relocalized within 0.15 m); the Sim3 pose graph on the 12-node drift
   loop of tests/test_sim3_mono.py card against CPU within 1e-4, wall ms
   per solve. (d) build_multistream_mono at B = 4, 512x384, the vmapped
   program as one CUDA graph replay: torch.equal to the eager vmapped
   program; each lane against the stream's own mono_step call (the
   programs round differently): counts, matches and gates equal, the
   pose, observations, post-update information, psi and Lambda each
   within 1e-5 or within twice the single call's own move over 4 one-ulp
   moves of its f32 state where that is larger; ms per replay against
   four eager calls.

14. viewers, dictionary, mesh — (a) a SlamSystem (unthreaded, Config(),
   512x384, keep_kf_images) on phase 4's first 20 frames: all 7 debug
   views at pyramid levels 0 and 2 (384x512x3 and 96x128x3; the right and
   color_disp views are full size at any level, as the twin's), each with
   one synchronizing call under sync debug mode "warn", its PNG decoding
   back to the rendered array, color_disp lit exactly where the disparity
   is valid, wall ms and device ms (CUDA events); the last keyframe's view,
   the timing plot, the top-down map with trajectory and ground truth, and
   the map3d HTML with one keyframe per graph vertex. (b) phase 11's tree
   through stereo_slam.main threaded + pipelined at depth 3 with --viz
   --viz-html --timing-plot --keyframe-view --debug-mode 6 --debug-every
   10 --watch (period 0.5 s; a tunables.cfg with debug_mode = 3 written
   before the run): 80/80 tracked, ATE < 0.05 m, one kernel launch per
   frame, every artifact written, status.json with the twin's keys and
   debug_mode 3, frames/s beside phase 11 (a)'s; then mono_vo.main with
   --viz --viz-html --watch on 40 frames of phase 13's tree. (c)
   create_dictionary.main --synthetic with the corpus cut to 2 scenes x 8
   frames (recipe v2: 64 images): a (4096, 128) vocabulary of unit rows;
   descriptors per image and train_vocabulary's ms per Lloyd iteration
   beside its bound; the directory mode on 10 of phase 11's left images.
   (d) the mesh over the one card listed 2-4 times: the tracking step at
   (dp, sp) = (2, 1) and (1, 2) within 1e-5 of mesh=None;
   build_sharded_ba at sp = 2 and 4 on phase 8's last problem at the full
   caps within 1e-4 relative of solve_ba (R, t, psi, chi2), device ms of
   both; StreamPool of 8 streams over dp = 2 on phase 7's ticks: every
   trajectory within 1e-5 m of phase 7's, or, where the B = 4 and B = 8
   programs round differently (phase 7 (b)'s state through both: each
   lane within (b)'s bars, not bit-equal), phase 15's rule: ATE within
   1% relative per stream and the same keyframe counts; one capture and a
   replay per later tick on each shard, 2 batched launches per tick and
   no single-image launch; phase 8's unthreaded run with the solve on a
   2-shard mesh: every frame tracked, keyframes within 1 and ATE within 1%
   of phase 8's, a solve adopted without raising chi2. Copies between
   cards are not measured: the machine has one card.

15. parity — the port on the card against the port on the CPU, in one
   process, on frames rendered once on the CPU by the port's renderer and
   quantized to uint8 as benchmarks/tpu_cpu_parity.py does (the card run
   uploads them), with the place recognizer's RANSAC draws from one CPU
   generator seeded 42 on both devices (CpuDraws). Every run unthreaded,
   synchronous, loop closure on and pr_lossless; the CPU runs on a worker
   thread beside the card's. (a) phase 9's spin (256x192, 90 frames) at
   stereo method 2 (the kernel on the card, its plain version on the
   CPU), a second card run, and method 1 on both; (b) phase 8's wander at
   512x384 with Config(), cut to its first 40 frames for the script's
   time. Each pair must track every frame, with ATE within 1% relative
   (the north star) and the same keyframes and solves, and on the spin
   the same METRIC and
   APPEARANCE edges and closed loops; the two card runs are held to the
   same bars. Printed beside them, unchecked: the RMSE between the two
   trajectories (traj_rmse_m), the first frame whose positions lie more
   than 1e-4 m apart, bit-equality, each run's wall time and the recorded
   port-CPU-to-JAX-CPU link. One kernel launch per frame in each card run
   at method 2, none elsewhere. Reported only (gated on tracking every
   frame): MonoFrontend on config 6's forward arc cut to 40 frames, card
   against CPU, keyframes and Sim3-aligned ATE.

16. step graph — the stereo frame step as StereoFrontend runs it on a
   card, a CUDA graph replay (models/step_graph.StepGraph), at 512x384
   with Config(). (a) From the state after phase 4's first 12 frames (>= 2
   keyframes), frame 12's frontend_step arguments: the eager step, then a
   StepGraph captured on them and replayed once; every output of the
   replay (packed vector, disparity, next dense state, ...) torch.equal to
   the eager step's, the block-matching counter moved by one per replay;
   the same with stereo methods 3 and 4 (no block-matching launch) and
   with an external-disparity stack (ground truth; none). Host ms of each
   call; at methods 2 and 3 the ms between CUDA events, eager and
   replayed. (b) Phase 4's frames 1..10 through process_frame on a fresh
   frontend, the step as a graph and then eager: synchronizing calls per
   frame (sync debug mode "warn"), exactly one (the packed download) on
   every graph frame that spawns no keyframe; one block-matching launch
   per frame stepped; wall ms per frame.

17. dense_ic — the dense tracker's inverse-compositional evaluation
   (ops/dense_ic.py) at the benchmark cells' level shapes
   (probes/dense_ic_cases.py: nc one stream with 49,152 / 12,288 / 12,288
   points at levels 0-2, fleet 8 streams with 12,288 / 3,072 / 12,288,
   clouds of rendered frames, at the identity and at a nearby pose, each
   stream its own with t up to ~1 cm): at each, the kernel within
   2e-7 of the float64 sum of the plain version's per-point terms (H, b,
   chi2, over the largest entry) and its difference from the plain
   version, the batched call (fleet) bit-equal to per-lane calls and two
   graph replays bit-equal to the eager calls; microseconds a call in a graph of 31 calls (one level's
   evaluations), kernel and plain version, beside the bytes bound (41 B a
   point and the image once at 3.35 TB/s); and the launches per step
   replay (phase 4) and per tick replay (phase 7), 93 each (3 levels x (1 +
   30 trips)).

After the phases, torch.profiler (last, so that its tracing cannot slow the
timed phases): the device time of each kernel of one single-image
block-matching call, and the launches and summed kernel time per BP, per
CSBP, per mono_step call, per frame step (eager and replayed, phase
16) and per replay of the pool's tick program (phase 7 b, beside phase
16's single-stream replay). The last four lines are the per-kernel JSON record, the script's
time, the card's name and power limit, and the result line.
"""

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROUTE_SOURCE = "scavislam_tpu_torch/csrc/stereo_bm.cu"
# block_matching_disparity_pallas (its body is _bm_kernel, :70)
REPLACES = "scavislam_tpu/ops/stereo_pallas.py:254"
# block_matching_disparity_pallas_batched
REPLACES_BATCHED = "scavislam_tpu/ops/stereo_pallas.py:322"
N_FRAMES = 80
N_STREAMS = 8
N_TICKS = 24  # cut from 40 when phase 8 came, to keep the script's time
POOL_STATE_TICKS = 12  # phase 7 (b) steps from the state after these ticks
# synchronizing calls of one keyframe spawn, its five uploads from pageable
# host memory (StereoFrontend._se3's R and t, PoseTable.set's valid flag,
# spawn_points_step's patch offsets and spawn_points_step_packed's
# input); a pool tick makes these and no other
SPAWN_SYNCS = 5
TIMING_RUNS = 25
ATE_MAX = 0.05
# the bound: each cost entry (pixel x disparity) needs |L - R|, 10
# horizontal adds, 10 vertical adds and ~3 compares (left view, runner-up,
# right view); the texture sum (<2% more) is left out. H100 SXM peaks:
# 67 TFLOP/s fp32 outside the tensor cores, 3.35 TB/s device memory.
OPS_PER_COST_ENTRY = 25
FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def _fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _cuda_ms(fn, runs):
    """Median milliseconds of `fn()` over `runs` runs, CUDA events. A
    ~1 ms device sleep before the first event keeps the card busy while
    the host enqueues the run, so a short call is timed on the device and
    not at the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _bound_ms(b, h, w, num_disp):
    """(least ms the card could take, "operations" or "bytes") for block
    matching B images of H x W at num_disp disparities: two f32 inputs
    read and one f32 output written once."""
    ops_ms = 1e3 * OPS_PER_COST_ENTRY * b * h * w * num_disp / FP32_OPS_PER_S
    bytes_ms = 1e3 * 3 * 4 * b * h * w / HBM_BYTES_PER_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def _ptxas(log):
    """{kernel: (registers, static smem bytes, spill bytes)} from the
    build's `-Xptxas -v` report."""
    out, name = {}, None
    for line in log.read_text().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)", line)
        if m:
            name = next((k for k in ("bm_cost_kernel", "bm_lr_kernel",
                                     "dense_ic_partial_kernel",
                                     "dense_ic_final_kernel")
                         if k in m.group(1)), m.group(1))
            out.setdefault(name, [0, 0, 0])
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name][2] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name][0] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name][1] = int(sm.group(1)) if sm else 0
    return {k: tuple(v) for k, v in out.items()}


def _kernel_profile(fn, runs):
    """[(device kernel name, launches per call, microseconds per call)]
    over `runs` calls of fn, from torch.profiler's CUDA activity."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return [(e.key, e.count / runs, e.device_time_total / runs)
            for e in prof.key_averages() if e.device_time_total]


def _ate(est, gt):
    errs = []
    for Te, Tg in zip(est, gt):
        Rg = Tg.R.numpy().astype(np.float64)
        tg = Tg.t.numpy().astype(np.float64)
        errs.append(Te.R @ (-Rg.T @ tg) + Te.t)  # translation of Te @ Tg^-1
    errs = np.stack(errs)
    return float(np.sqrt((errs ** 2).sum(axis=1).mean()))


def _run_system(cam, cfg, dev, frames, threaded, pipelined,
                loop_closure=False, warm_pr=False, solve_mesh=None):
    """One SlamSystem run over `frames` (bench.py's headline configuration
    when threaded and pipelined; with loop closure, pr_lossless as
    benchmarks/run_configs.py config 2 runs it; `solve_mesh` shards the
    backend's solve). Returns its numbers."""
    from scavislam_tpu_torch.pipeline.slam_system import SlamSystem
    system = SlamSystem(cam, cfg, threaded=threaded,
                        enable_loop_closure=loop_closure,
                        pipelined=pipelined,
                        pipeline_depth=3 if pipelined else None,
                        pr_lossless=loop_closure, device=dev)
    system.backend.graph.solve_mesh = solve_mesh
    if warm_pr:
        system.place_recognizer.warmup()
    fe = system.frontend
    adopted = [0]
    apply_nb = fe.apply_neighborhood

    def counting_apply(nb):
        ok = apply_nb(nb)
        adopted[0] += bool(ok)
        return ok

    fe.apply_neighborhood = counting_apply
    fe.timing_log = [] if pipelined else None
    failed = None
    try:
        system.process_first_frame(frames[0])
        ok = system.process_frame(frames[1])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for f in frames[2:]:
            if not ok:
                failed = f["frame_id"] - 1
                break
            ok = system.process_frame(f)
        system._flush_frontend()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        system.finish()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    finally:
        system.shutdown()
    if not ok and failed is None:
        failed = frames[-1]["frame_id"]
    g = system.backend.graph
    gt = {f["frame_id"]: f["T_cw_gt"] for f in frames}
    traj = sorted((e for e in system.trajectory if e[0] in gt),
                  key=lambda e: e[0])
    ate = _ate([T for _, T in traj], [gt[i] for i, _ in traj])
    solve_ms = [ms for _, ms in g.solve_log]
    return {
        "system": system, "failed": failed, "tracked": len(traj),
        "frames": len(frames), "fps": (len(frames) - 2) / (t2 - t1),
        "drain_s": t3 - t2, "keyframes": fe.next_kf,
        "vertices": len(g.vertices), "solves": len(solve_ms),
        "solve_ms_median": float(np.median(solve_ms)) if solve_ms else None,
        "chi2": (g.stats["chi2_init"], g.stats["chi2_final"]),
        "counters": dict(sorted(system.backend.counters.items())),
        "adopted": adopted[0], "ate": ate,
        "split": (np.asarray([x[1:4] for x in fe.timing_log]).mean(0) * 1e3
                  if fe.timing_log else None),
    }


def _check_system(name, r, launches, batched_launches):
    ms = r["solve_ms_median"]
    print(f"{name}: {r['tracked']}/{r['frames']} frames tracked, "
          f"{r['keyframes']} keyframes, {r['vertices']} graph vertices, "
          f"{r['solves']} solves adopted (median "
          f"{'none' if ms is None else f'{ms:.3f}'} device ms, last chi2 "
          f"{r['chi2'][0]:.3f} -> {r['chi2'][1]:.3f}), counters "
          f"{r['counters']}, neighborhoods adopted {r['adopted']}, ATE "
          f"{r['ate']:.5f} m, {r['fps']:.2f} frames/s over frames 2.."
          f"{r['frames'] - 1} (finish drain {1000 * r['drain_s']:.1f} ms), "
          f"kernel launches {launches} for {r['frames']} frames dispatched, "
          f"batched launches {batched_launches}"
          + ("" if r["split"] is None else
             "; per frame ms dispatch {:.2f} fetch wait {:.3f} consume "
             "{:.2f}".format(*r["split"])), flush=True)
    if r["failed"] is not None or r["tracked"] != r["frames"]:
        _fail(f"{name}: tracking failed at frame {r['failed']}")
    if r["vertices"] != r["keyframes"]:
        _fail(f"{name}: graph vertices {r['vertices']} != keyframes "
              f"{r['keyframes']}")
    if r["solves"] < 1 or not r["chi2"][1] <= r["chi2"][0]:
        _fail(f"{name}: no solve adopted with chi2_final <= chi2_init")
    if not r["ate"] < ATE_MAX:
        _fail(f"{name}: ATE {r['ate']} m")
    if launches != r["frames"] or batched_launches != 0:
        _fail(f"{name}: kernel launches {launches} != {r['frames']} frames")


def _graph_of(fn):
    """fn captured as a CUDA graph (after a warm-up on a side stream, as
    torch.cuda.graphs asks): (graph, outputs of the captured call)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def _time_solve(graph):
    """solve_ba alone on the graph's last packed problem. Eagerly the host
    enqueues ~600 small launches per solve and the card waits on it, so the
    device time is taken from the solve captured as a CUDA graph and
    replayed: median ms of 25 replays (CUDA events), and the same for each
    stage of one LM round (normal equations, Schur product, Cholesky plus
    back-substitution) captured alone; the eager call's wall time beside."""
    from scavislam_tpu_torch.models import ba_solver as B
    from scavislam_tpu_torch.models.slam_graph import _unpack_problem
    if graph.last_problem is None:
        _fail("solve: no problem was dispatched")
    cam_params, buf, caps = graph.last_problem
    prob, aperm = _unpack_problem(buf, caps)
    n_obs = int(prob.obs_valid.sum())
    n_pts = int(prob.point_valid.sum())
    n_poses = int(prob.pose_valid.sum())

    def solve():
        return B.solve_ba(cam_params, prob, iters=2, huber=3.0,
                          anchor_perm=aperm)

    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    g_solve, out = _graph_of(solve)
    ms = _cuda_ms(g_solve.replay, TIMING_RUNS)
    if not float(out[3].chi2_final) <= float(out[3].chi2_initial):
        _fail("solve: the captured solve raised chi2")
    free = (prob.pose_valid & ~prob.pose_fixed).to(torch.float32)
    lam = torch.full((), 50.0, device=buf.device)
    lin = B._linearize(cam_params, prob, prob.R, prob.t, prob.psi, lam, free,
                       3.0, aperm, None)
    sch = B._schur(*lin, lam, free)
    stages = {
        "normal equations": lambda: B._linearize(
            cam_params, prob, prob.R, prob.t, prob.psi, lam, free, 3.0,
            aperm, None),
        "Schur product": lambda: B._schur(*lin, lam, free),
        "Cholesky + back-substitution": lambda: B._factor_solve(
            *sch, lin[1], lin[2], lin[4], free, prob.point_valid),
    }
    split = {k: _cuda_ms(_graph_of(f)[0].replay, TIMING_RUNS)
             for k, f in stages.items()}
    print(f"solve: solve_ba at caps (P, L, O, E) = {caps}, 2 LM rounds, "
          f"{n_poses} poses, {n_pts} points, {n_obs} observations: median "
          f"{ms:.3f} device ms over {TIMING_RUNS} replays of the solve "
          f"captured as a CUDA graph (eager, host-bound: "
          f"{float(np.median(walls)):.2f} ms wall); per LM round (median of "
          f"{TIMING_RUNS} graph replays each): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
          + f"; last chi2 {float(out[3].chi2_initial):.3f} -> "
          f"{float(out[3].chi2_final):.3f}", flush=True)


LOOP_FRAMES = 90
LOOP_ATE_MAX = 0.1
RELOC_ERR_MAX = (0.25, 0.08)


def _loop_cam_cfg(cfg, parallax_thr, windows=None):
    """The 256x192 camera of the repo's loop-closure and relocalization
    workloads, and `cfg` cut to them (covis_thr 10, the parallax threshold,
    the graph windows when given)."""
    from scavislam_tpu_torch.core.camera import StereoCamera
    cam = StereoCamera.create(195.0, (127.0, 95.0), (256, 192), 0.12)
    out = dataclasses.replace(
        cfg, frontend=dataclasses.replace(cfg.frontend, covis_thr=10),
        ui=dataclasses.replace(cfg.ui, parallax_thr=parallax_thr))
    if windows is not None:
        out = dataclasses.replace(out, graph=dataclasses.replace(
            out.graph, inner_window=windows[0], outer_window=windows[1]))
    return cam, out


def _phase_loop(cfg, dev):
    """Phase 9: benchmarks/run_configs.py config 2 through the port, then
    the recognizer's device costs."""
    from scavislam_tpu_torch.io.synthetic import SyntheticSequence, closed_box
    from scavislam_tpu_torch.models.frontend import (NEW_PER_LEVEL,
                                                     TRACKED_CAP,
                                                     StereoFrontend)
    from scavislam_tpu_torch.models.frontend_step import (
        spawn_points_step_packed)
    from scavislam_tpu_torch.models.placerec import _geom_check_device
    from scavislam_tpu_torch.models.slam_graph import APPEARANCE, METRIC
    from scavislam_tpu_torch.ops import stereo_bm
    from scavislam_tpu_torch.ops.descriptors import bow_describe

    cam, lcfg = _loop_cam_cfg(cfg, 0.25, windows=(3, 8))
    n = LOOP_FRAMES
    seq = SyntheticSequence(cam, n_frames=n, kind="spin", planes=closed_box(),
                            step=1.0 / (n - 1), device=dev)
    frames = []
    for i in range(n):
        f = seq.frame(i)
        frames.append({"frame_id": i, "left": f["left"], "right": f["right"],
                       "T_cw_gt": f["T_cw_gt"]})
    _run_system(cam, lcfg, dev, frames[:12], threaded=True, pipelined=True,
                loop_closure=True, warm_pr=True)
    torch.cuda.synchronize()
    stereo_bm.block_matching_disparity_bm.launches = 0
    stereo_bm.block_matching_disparity_bm_batched.launches = 0
    r = _run_system(cam, lcfg, dev, frames, threaded=True, pipelined=True,
                    loop_closure=True, warm_pr=True)
    launches = stereo_bm.block_matching_disparity_bm.launches
    batched = stereo_bm.block_matching_disparity_bm_batched.launches
    system = r["system"]
    pr = system.place_recognizer
    g = system.backend.graph
    types = [e.edge_type for e in g.edges.values()]
    far = sorted((a, b, e.edge_type) for (a, b), e in g.edges.items()
                 if abs(a - b) > 4 and e.edge_type in (APPEARANCE, METRIC))
    glc = {k: v for k, v in sorted(r["counters"].items())
           if k.startswith("glc_") or k.startswith("reg_")}
    print(f"loop: {r['tracked']}/{n} frames tracked, {r['keyframes']} "
          f"keyframes, {r['vertices']} graph vertices, {r['fps']:.2f} "
          f"frames/s over frames 2..{n - 1} (finish drain "
          f"{1000 * r['drain_s']:.1f} ms), ATE {r['ate']:.5f} m, lost at the "
          f"end {system.lost}, relocalizations {system.relocalizations}; "
          f"recognizer counters {dict(sorted(pr.counters.items()))}; backend "
          f"{glc}; closed loops {system.closed_loops}; METRIC edges "
          f"{types.count(METRIC)}, APPEARANCE edges {types.count(APPEARANCE)},"
          f" reconnecting edges (|a - b| > 4) {far}; kernel launches "
          f"{launches} for {n} frames dispatched, batched launches {batched}",
          flush=True)
    if r["tracked"] < n - 2:
        _fail(f"loop: {r['tracked']}/{n} frames tracked")
    if not far and not system.closed_loops:
        _fail("loop: the revisit did not reconnect the graph")
    if not r["ate"] < LOOP_ATE_MAX:
        _fail(f"loop: ATE {r['ate']} m")
    if launches != n or batched != 0:
        _fail(f"loop: kernel launches {launches} != {n} frames")
    off = _run_system(cam, lcfg, dev, frames, threaded=True, pipelined=True)
    print(f"loop: the same frames with loop closure off: {off['fps']:.2f} "
          f"frames/s (on: {r['fps']:.2f}), {off['tracked']}/{n} tracked, "
          f"{off['keyframes']} keyframes, ATE {off['ate']:.5f} m, backend "
          f"{off['counters']}", flush=True)
    fe = StereoFrontend(cam, lcfg, device=dev)
    fe.pipeline_depth = 3
    fe.process_first_frame(frames[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in frames[1:]:
        fe.process_frame_pipelined(f)
    fe.flush_pipeline()
    torch.cuda.synchronize()
    print(f"loop: the pipelined frontend alone (depth 3, no backend) on the "
          f"same frames: {(n - 1) / (time.perf_counter() - t0):.2f} frames/s "
          f"over frames 1..{n - 1}, {fe.next_kf} keyframes", flush=True)

    # the recognizer's device costs at this workload's shapes
    fe = system.frontend
    pkt = fe.to_optimizer_stack[-1]
    packed_in = np.zeros(3 * TRACKED_CAP + fe.levels + 1, np.float32)
    packed_in[3 * TRACKED_CAP: 3 * TRACKED_CAP + fe.levels] = np.cumsum(
        (0,) + NEW_PER_LEVEL[: fe.levels - 1])
    clearance = float(lcfg.frontend.newpoint_clearance)

    def spawn(vocab):
        return spawn_points_step_packed(
            pkt.pyr, pkt.disp, packed_in, fe.points, fe._cam_params,
            fe._cam_statics, fe.levels, NEW_PER_LEVEL[: fe.levels],
            clearance, TRACKED_CAP, vocab)

    ms_spawn_pr = _cuda_ms(lambda: spawn(fe.pr_vocab), TIMING_RUNS)
    ms_spawn = _cuda_ms(lambda: spawn(None), TIMING_RUNS)
    ms_spawn_pr2 = _cuda_ms(lambda: spawn(fe.pr_vocab), TIMING_RUNS)
    cam0 = fe._cam_params[0]
    g_desc, _ = _graph_of(lambda: bow_describe(pkt.pyr[0], pkt.disp,
                                               fe.pr_vocab, cam0))
    ms_desc = _cuda_ms(g_desc.replay, TIMING_RUNS)

    # the geometric check at the 256-key capacity, on two indexed places
    # (the last query and its best candidate when it had one)
    ids = sorted(pr.location_map)
    qa = pr.location_map[ids[-1]]
    cb = pr.location_map[pr.last_best[0] if pr.last_best else ids[0]]
    arrays = qa.padded + cb.padded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fut = pr._check_dispatch(*arrays)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    res = fut.result()
    parts = [torch.as_tensor(a, device=dev) for a in arrays]
    idx = pr.hypotheses(len(arrays[0]))
    torch.cuda.synchronize()
    g_chk, _ = _graph_of(lambda: _geom_check_device(
        idx, *parts, pr._cam_params, 3.0))
    ms_check = _cuda_ms(g_chk.replay, TIMING_RUNS)
    walls = []
    for _ in range(TIMING_RUNS):
        t0 = time.perf_counter()
        pr._check_dispatch(*arrays).result()
        walls.append(1e3 * (time.perf_counter() - t0))
    ms_check_wall = float(np.median(walls))
    walls = []
    hits = 0
    for _ in range(TIMING_RUNS):
        t0 = time.perf_counter()
        hit = pr.relocalize(pkt.pyr[0], pkt.disp)
        walls.append(1e3 * (time.perf_counter() - t0))
        hits += hit is not None
    ms_reloc = float(np.median(walls))
    print(f"loop: keyframe spawn step {ms_spawn_pr:.3f} / {ms_spawn_pr2:.3f} "
          f"ms with the {tuple(fe.pr_vocab.shape)} vocabulary against "
          f"{ms_spawn:.3f} ms without (CUDA events around the eager call, "
          f"median of {TIMING_RUNS}); bow_describe alone {ms_desc:.4f} device "
          f"ms (CUDA graph replay); geometric check at {len(arrays[0])} keys "
          f"{ms_check:.4f} device ms (graph replay), {ms_check_wall:.2f} ms "
          f"wall with its upload and download, enqueued with no synchronizing "
          f"call (sync debug mode error), result n_matched {int(res[12])} "
          f"n_inliers {int(res[13])}; relocalize {ms_reloc:.2f} ms wall "
          f"(median of {TIMING_RUNS}, {hits} hits)", flush=True)


def _phase_relocalize(cfg, dev):
    """Phase 10: tests/test_relocalization.py's kidnap on the card."""
    from scavislam_tpu_torch.core.lie import PoseRT
    from scavislam_tpu_torch.io.synthetic import SyntheticSequence
    from scavislam_tpu_torch.ops import stereo_bm
    from scavislam_tpu_torch.pipeline.slam_system import SlamSystem

    cam, rcfg = _loop_cam_cfg(cfg, 0.08)
    seq = SyntheticSequence(cam, n_frames=14, step=0.02, device=dev)
    frames = [seq.frame(i) for i in range(14)]
    rng = np.random.RandomState(0)

    def err(system, fid, T_gt):
        T = PoseRT.from_any(dict(system.trajectory)[fid])
        return float(np.linalg.norm((T @ PoseRT.from_any(T_gt).inverse()).t))

    stereo_bm.block_matching_disparity_bm.launches = 0
    system = SlamSystem(cam, rcfg, threaded=False, device=dev)
    fed = 1
    system.process_first_frame(frames[0])
    for f in frames[1:10]:
        fed += 1
        if not system.process_frame(dict(f)) or system.lost:
            _fail(f"relocalize: tracking failed at frame {f['frame_id']}")
    places = len(system.place_recognizer.location_map)
    for k in range(3):
        fed += 1
        noise = {"frame_id": 100 + k,
                 "left": torch.as_tensor(rng.rand(192, 256).astype(np.float32),
                                         device=dev),
                 "right": torch.as_tensor(rng.rand(192, 256).astype(np.float32),
                                          device=dev)}
        if not system.process_frame(noise):
            _fail("relocalize: a noise frame ended the run")
    lost = system.lost
    t0 = time.perf_counter()
    fed += 1
    system.process_frame(dict(frames[5], frame_id=200))
    ms = 1e3 * (time.perf_counter() - t0)
    relocated = not system.lost and system.relocalizations == 1
    e1 = err(system, 200, frames[5]["T_cw_gt"]) if relocated else None
    for i in range(6, 9):
        fed += 1
        system.process_frame(dict(frames[i], frame_id=200 + i))
    e2 = (err(system, 208, frames[8]["T_cw_gt"])
          if relocated and not system.lost else None)
    system.finish()
    system.shutdown()
    launches = stereo_bm.block_matching_disparity_bm.launches
    print(f"relocalize: {places} places indexed after 10 frames; lost after 3 "
          f"noise frames {lost}; frame 5 again: relocalized {relocated} "
          f"({system.relocalizations} relocalizations, {ms:.1f} ms for that "
          f"frame), position error {e1} m; 3 frames later {e2} m; kernel "
          f"launches {launches} for {fed} frames fed", flush=True)
    if not lost:
        _fail("relocalize: the noise frames did not put the system in lost "
              "mode")
    if not relocated or not e1 < RELOC_ERR_MAX[0]:
        _fail(f"relocalize: no relocalization within {RELOC_ERR_MAX[0]} m")
    if e2 is None or not e2 < RELOC_ERR_MAX[1]:
        _fail(f"relocalize: error {e2} m after 3 frames")
    if launches != fed:
        _fail(f"relocalize: kernel launches {launches} != {fed} frames")


BP_FRAMES = 40
# ATE limits of (c): BP twice the block matcher's (dense, no validity
# test); CSBP's whole-pixel disparities cost the tracker more: 0.1696 and
# 0.1707 m in this phase on an H100. The JAX package's CSBP loses as much
# (0.1907 m on a different sequence, the 40-frame closed-box wander at
# 256x192, where the port scores the same: tests/test_torch_stereo_bp.py::
# test_csbp_wander_matches_jax)
BP_ATE_MAX = {3: 0.1, 4: 0.2}
BP_OPTS = (5, 4)  # (iters, levels): frontend_step's floor over Config()'s
CSBP_OPTS = (4, 4, 4)  # Config()'s (iters, levels, nr_plane)
RECT_FRAMES = 40
RECT_DIST = (-0.04, 0.01, 0.0, 0.0, 0.0)  # (k1, k2, p1, p2, k3), both eyes


def _write_pnm(path, img):
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())


def _read_pnm(path):
    """A P5 file's pixels (the header as _write_pnm writes it)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, w, h, _maxval, pix = data.split(maxsplit=4)
    if magic != b"P5":
        _fail(f"disk: {path} is not P5")
    return np.frombuffer(pix, np.uint8).reshape(int(h), int(w))


def _u8(x):
    return (torch.clamp(x, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def _cfg_text(cfg, framepipe):
    """A reference-format .cfg: the camera of `cfg` and framepipe keys."""
    c = cfg.cam
    lines = [f"cam.width = {c.width};", f"cam.height = {c.height};",
             f"cam.f = {c.f};", f"cam.px = {c.px};", f"cam.py = {c.py};",
             f"cam.baseline = {c.baseline};"]
    lines += [f"framepipe.{k} = {v};" for k, v in framepipe.items()]
    return "\n".join(lines) + "\n"


def _write_newcollege(root, frames, cfg):
    """frames as the reference's New College tree: timestamped P5 pairs
    over two segment directories, and a .cfg pointing at them."""
    segs = [os.path.join(root, "StereoImages_1225720041_to_1225720118"),
            os.path.join(root, "StereoImages_1225720118_to_1225720193")]
    for d in segs:
        os.makedirs(d)
    n = len(frames)
    for i, f in enumerate(frames):
        base = os.path.join(segs[i // (n // 2 + 1)],
                            f"StereoImage__{1225720041.455302 + 0.05 * i:.6f}"
                            "-rectified-")
        for side in ("left", "right"):
            _write_pnm(base + f"{side}.pnm", _u8(f[side]).cpu().numpy())
    path = os.path.join(root, "newcollege.cfg")
    with open(path, "w") as fh:
        fh.write(_cfg_text(cfg, {"path_str": root,
                                 "base_str": ".*rectified.*",
                                 "format_str": "pnm", "right_img": 1}))
    return path


def _cli(args):
    """apps/stereo_slam.main with its JSON summary captured, not printed;
    returns the summary."""
    from scavislam_tpu_torch.apps import stereo_slam
    with contextlib.redirect_stdout(io.StringIO()):
        return stereo_slam.main(args)


def _traj_ate(path, frames):
    """(frame ids, ATE) of a trajectory file the CLI wrote (rows: frame id,
    t, rotation log) against the frames' ground truth."""
    from scavislam_tpu_torch.core.lie import SO3, PoseRT
    rows = np.atleast_2d(np.loadtxt(path))
    R = SO3.exp(torch.as_tensor(rows[:, 4:7], dtype=torch.float32)).R
    est = [PoseRT(R[k].numpy().astype(np.float64), r[1:4])
           for k, r in enumerate(rows)]
    fids = [int(r[0]) for r in rows]
    return fids, _ate(est, [frames[i]["T_cw_gt"] for i in fids])


def _distort_frames(cam, frames, dev):
    """Each frame as a camera with RECT_DIST would see it: a distorted pixel
    samples the clean render bilinearly at its undistorted coordinate,
    found by 5 fixed-point iterations (OpenCV's undistortPoints)."""
    from scavislam_tpu_torch.ops.image import bilinear_sample
    w, h = cam.size
    f, (px, py) = float(cam.focal), cam.pp
    k1, k2 = RECT_DIST[:2]
    us, vs = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    xd, yd = (us - px) / f, (vs - py) / f
    x, y = xd.copy(), yd.copy()
    for _ in range(5):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        x, y = xd / radial, yd / radial
    uv = torch.as_tensor(np.stack([x * f + px, y * f + py], -1)
                         .astype(np.float32), device=dev)
    return [{"frame_id": fr["frame_id"], "T_cw_gt": fr["T_cw_gt"],
             "left": _u8(bilinear_sample(fr["left"], uv)[0]),
             "right": _u8(bilinear_sample(fr["right"], uv)[0])}
            for fr in frames]


def _phase_disk(cam, cfg, dev, seq, frames, fps_lc, tmp):
    """Phase 11: the disk-sequence entry point, its files under `tmp`.
    Returns (the single-image kernel launches of its checked runs, (a) and
    (d); the New College tree's .cfg; (a)'s frames/s)."""
    from scavislam_tpu_torch.apps.dump_sequence import record
    from scavislam_tpu_torch.io.filegrabber import FileGrabber
    from scavislam_tpu_torch.ops import stereo_bm
    from scavislam_tpu_torch.ops.rectify import Rectifier, _rectify_stack
    n = len(frames)
    bm = stereo_bm.block_matching_disparity_bm
    # -- (a) stereo from disk through the CLI
    root = os.path.join(tmp, "newcollege")
    cfg_path = _write_newcollege(root, frames, cfg)
    out = os.path.join(tmp, "trajectory.txt")
    args = [cfg_path, "--threaded", "--pipelined", "--pipeline-depth",
            "3", "--out", out]
    _cli(args + ["--max-frames", "12"])
    torch.cuda.synchronize()
    bm.launches = 0
    summ = _cli(args)
    launches_a = bm.launches
    fids, ate = _traj_ate(out, frames)
    print(f"disk (a): New College tree through stereo_slam.main "
          f"(threaded, pipelined depth 3, loop closure on): "
          f"{summ['frames_processed']} frames processed, {len(fids)} "
          f"tracked, {summ['keyframes']} keyframes, "
          f"{summ['closed_loops']} closed loops, ATE {ate:.5f} m, "
          f"{summ['frames_per_s']:.2f} frames/s over frames 2..{n - 1} "
          f"(phase 8 in memory, loop closure on: {fps_lc:.2f}), wait in "
          f"next_frame {summ['grab_wait_ms']:.3f} ms per frame; kernel "
          f"launches {launches_a} for {n} frames", flush=True)
    if summ["frames_processed"] != n or fids != list(range(n)):
        _fail(f"disk (a): {len(fids)}/{n} frames tracked")
    if not ate < ATE_MAX:
        _fail(f"disk (a): ATE {ate} m")
    if summ["keyframes"] < 2:
        _fail("disk (a): fewer than 2 keyframes")
    if launches_a != n:
        _fail(f"disk (a): kernel launches {launches_a} != {n} frames")

    # -- (b) the grabber alone: decode + prefetch, no SLAM
    from scavislam_tpu_torch.models.frontend import StereoFrontend
    fe = StereoFrontend(cam, cfg, device=dev)
    log = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = FileGrabber(root, base_pattern=".*rectified.*", fmt="pnm",
                    device_prefetch=True, device=dev, timing_log=log)
    # as the frame step takes them
    got = [fe._prefetched(f, "stacked_dev") for f in g]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    g.close()
    equal = all(torch.equal(s, torch.as_tensor(np.stack([
        _read_pnm(lp), _read_pnm(lp.replace("left", "right"))]),
        device=dev)) for s, lp in zip(got, g.left_files))
    decode_ms = 1e3 * float(np.mean([d for _, d, _ in log]))
    upload_ms = float(np.mean([a.elapsed_time(b) for _, _, (a, b) in log]))
    # the copy alone, with the host's enqueue hidden (_cuda_ms): the
    # span above also holds the producer thread's time between events
    pinned = torch.empty(got[0].shape, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty_like(got[0])
    copy_ms = _cuda_ms(lambda: dst.copy_(pinned, non_blocking=True),
                       TIMING_RUNS)
    print(f"disk (b): grabber alone, {len(got)} frames decoded natively "
          f"and copied to the card in {dt:.3f} s: {len(got) / dt:.1f} "
          f"frames/s; per frame decode {decode_ms:.3f} ms (host), upload "
          f"span {upload_ms:.4f} ms (CUDA events around the producer's "
          f"enqueue), the pinned copy alone {copy_ms:.4f} device ms "
          f"(median of {TIMING_RUNS}, {tuple(got[0].shape)} "
          f"{got[0].dtype}); every stack torch.equal to the files' "
          f"bytes {equal}", flush=True)
    if len(got) != n or not equal:
        _fail("disk (b): a prefetched frame differs from its files")

    # -- (c) RGB-D: record left + exact disparity, replay through the CLI
    dump = os.path.join(tmp, "rgbd")
    record(({"frame_id": i, "left": fr["left"], "disp_gt": fr["disp_gt"]}
            for i, fr in ((i, seq.frame(i)) for i in range(n))), dump)
    rgbd_cfg = os.path.join(tmp, "rgbd.cfg")
    with open(rgbd_cfg, "w") as fh:
        fh.write(_cfg_text(cfg, {"path_str": dump, "base_str": "img_.*",
                                 "format_str": "png", "right_img": 0,
                                 "disp_img": 1}))
    out_c = os.path.join(tmp, "trajectory_rgbd.txt")
    bm.launches = 0
    summ_c = _cli([rgbd_cfg, "--threaded", "--pipelined",
                   "--pipeline-depth", "3", "--out", out_c])
    launches_c = bm.launches
    fids_c, ate_c = _traj_ate(out_c, frames)
    print(f"disk (c): RGB-D dump replayed through stereo_slam.main "
          f"(external disparity, device prefetch): {len(fids_c)}/{n} "
          f"tracked, {summ_c['keyframes']} keyframes, ATE {ate_c:.5f} m, "
          f"{summ_c['frames_per_s']:.2f} frames/s, wait in next_frame "
          f"{summ_c['grab_wait_ms']:.3f} ms per frame; block-matching "
          f"launches {launches_c}", flush=True)
    if summ_c["frames_processed"] != n or fids_c != list(range(n)):
        _fail(f"disk (c): {len(fids_c)}/{n} frames tracked")
    if not ate_c < ATE_MAX:
        _fail(f"disk (c): ATE {ate_c} m")
    if launches_c != 0:
        _fail(f"disk (c): {launches_c} block-matching launches with "
              "external disparity")

    # -- (d) rectification
    def rcfg(dist, on):
        return dataclasses.replace(
            cfg, cam=dataclasses.replace(cfg.cam, dist_left=dist,
                                         dist_right=dist),
            framepipe=dataclasses.replace(cfg.framepipe, rectify_frame=on))

    stack = torch.stack([_u8(frames[0]["left"]), _u8(frames[0]["right"])])
    rect0 = Rectifier(cam, rcfg((0.0,) * 5, True), device=dev)
    identity = torch.equal(rect0.rectify_stacked(stack), stack)
    dframes = _distort_frames(cam, frames[:RECT_FRAMES], dev)
    rect = Rectifier(cam, rcfg(RECT_DIST, True), device=dev)
    dstack = torch.stack([dframes[0]["left"], dframes[0]["right"]])
    ms_rect = _cuda_ms(lambda: _rectify_stack(dstack, rect.map_left,
                                              rect.map_right), TIMING_RUNS)
    bm.launches = 0
    on = _run_system(cam, rcfg(RECT_DIST, True), dev, dframes, threaded=True,
                     pipelined=True, loop_closure=True)
    launches_d = bm.launches
    off = _run_system(cam, rcfg(RECT_DIST, False), dev, dframes,
                      threaded=True, pipelined=True, loop_closure=True)
    print(f"disk (d): zero-distortion rectify torch.equal to its input "
          f"{identity}; {RECT_FRAMES} frames distorted with (k1, k2) = "
          f"{RECT_DIST[:2]}, rectify on: {on['tracked']}/{RECT_FRAMES} "
          f"tracked, {on['keyframes']} keyframes, ATE {on['ate']:.5f} m, "
          f"kernel launches {launches_d}; rectify off (unchecked): "
          f"{off['tracked']}/{RECT_FRAMES} tracked, ATE {off['ate']:.5f} m; "
          f"_rectify_stack {ms_rect:.4f} device ms per frame (median of "
          f"{TIMING_RUNS}, {tuple(dstack.shape)} uint8)", flush=True)
    if not identity:
        _fail("disk (d): the zero-distortion rectify changed the frame")
    if on["failed"] is not None or on["tracked"] != RECT_FRAMES:
        _fail(f"disk (d): {on['tracked']}/{RECT_FRAMES} frames tracked")
    if not on["ate"] < ATE_MAX:
        _fail(f"disk (d): ATE {on['ate']} m")
    if launches_d != RECT_FRAMES:
        _fail(f"disk (d): kernel launches {launches_d} != {RECT_FRAMES}")
    return launches_a + launches_d, cfg_path, summ["frames_per_s"]


def _bp_bound_ms(h, w, num_disp, iters, levels, nr_plane=None):
    """Least ms for one BP (nr_plane None) or CSBP call at 3.35 TB/s: each
    round reads the data term and the four messages and writes the four
    messages once, at every level; the pair read and the output written
    once. CSBP runs full-D BP at its coarsest level and nr_plane candidates
    above it."""
    sizes = [(h, w)]
    for _ in range(1, levels):
        if min(sizes[-1]) < 2:
            break
        sizes.append(((sizes[-1][0] + 1) // 2, (sizes[-1][1] + 1) // 2))
    n = len(sizes)
    if nr_plane is None:
        planes = [num_disp] * n
    else:
        planes = [max(2, nr_plane)] * (n - 1) + [max(2, num_disp >> (n - 1))]
    entries = sum(d * hh * ww for d, (hh, ww) in zip(planes, sizes))
    nbytes = 4 * (9 * iters * entries + 3 * h * w)
    return 1e3 * nbytes / HBM_BYTES_PER_S


def _bp_calls(num_disp):
    """{name: f(left, right)} of the two methods at phase 12's options."""
    from scavislam_tpu_torch.ops.stereo_bp import (
        belief_propagation_disparity, constant_space_bp_disparity)
    return {
        "bp": lambda l, r: belief_propagation_disparity(
            l, r, num_disp, iters=BP_OPTS[0], levels=BP_OPTS[1]),
        "csbp": lambda l, r: constant_space_bp_disparity(
            l, r, num_disp, *CSBP_OPTS),
    }


def _phase_stereo_methods(f0, num_disp, ms_bm, nc_cfg, fps_a, frames, tmp):
    """Phase 12: stereo methods 3 and 4, alone, card against CPU, and
    through the CLI."""
    from scavislam_tpu_torch.ops import stereo_bm
    from scavislam_tpu_torch.ops.image import binomial3
    calls = _bp_calls(num_disp)
    left, right = binomial3(f0["left"]), binomial3(f0["right"])
    h, w = left.shape
    gt = f0["disp_gt"]
    interior = torch.zeros_like(gt, dtype=torch.bool)
    interior[8:-8, num_disp:-8] = True
    interior &= (gt > 1) & (gt < num_disp - 1)
    bounds = {"bp": _bp_bound_ms(h, w, num_disp, *BP_OPTS),
              "csbp": _bp_bound_ms(h, w, num_disp, CSBP_OPTS[0],
                                   CSBP_OPTS[1], CSBP_OPTS[2])}
    limits = {"bp": 1.0, "csbp": 1.5}
    # -- (a) alone at 512x384
    for name, fn in calls.items():
        d = fn(left, right)
        torch.cuda.synchronize()
        if tuple(d.shape) != (h, w) or not bool(torch.isfinite(d).all()):
            _fail(f"stereo methods (a): {name} output {tuple(d.shape)}, "
                  "not finite or not (H, W)")
        lo, hi = float(d.min()), float(d.max())
        if lo < 0 or hi > num_disp:
            _fail(f"stereo methods (a): {name} range [{lo}, {hi}]")
        med = float(torch.median(torch.abs(d - gt)[interior]))
        walls = []
        for _ in range(TIMING_RUNS):
            t0 = time.perf_counter()
            fn(left, right)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        ms_ev = _cuda_ms(lambda: fn(left, right), TIMING_RUNS)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn(left, right)
        torch.cuda.synchronize()
        peak_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
        try:
            g, out = _graph_of(lambda: fn(left, right))
        except RuntimeError as e:  # reported; the eager numbers stand
            graph = f"not captured ({type(e).__name__}: {e})"
        else:
            ms_g = _cuda_ms(g.replay, TIMING_RUNS)
            same = torch.equal(out, d)
            graph = (f"{ms_g:.3f} ms per replay (output torch.equal to the "
                     f"eager call's {same}), {100 * bounds[name] / ms_g:.2f}%"
                     " of the bound")
            del g
        print(f"stereo methods (a): {name} {(h, w)} D={num_disp}: range "
              f"[{lo:.3f}, {hi:.3f}], median |d-gt| {med:.4f} px on "
              f"{int(interior.sum())} interior pixels; eager "
              f"{float(np.median(walls)):.3f} ms wall, {ms_ev:.3f} ms "
              f"between CUDA events (median of {TIMING_RUNS}); CUDA graph "
              f"{graph}; peak {peak_mb:.1f} MiB allocated by the call; bound "
              f"{bounds[name]:.4f} ms (bytes); block matching (phase 3) "
              f"{ms_bm:.4f} ms", flush=True)
        if not med <= limits[name]:
            _fail(f"stereo methods (a): {name} median error {med} px")

    # -- (b) card against CPU on a 256x192 crop
    lc = left[96:288, 128:384].contiguous()
    rc = right[96:288, 128:384].contiguous()
    bp_g, cs_g = calls["bp"](lc, rc), calls["csbp"](lc, rc)
    bp_c, cs_c = calls["bp"](lc.cpu(), rc.cpu()), calls["csbp"](lc.cpu(),
                                                                rc.cpu())
    dbp = torch.abs(bp_g.cpu() - bp_c)
    frac_bp = float((dbp <= 1e-3).float().mean())
    frac_cs = float((cs_g.cpu() == cs_c).float().mean())
    print(f"stereo methods (b): {tuple(lc.shape)} crop, card against CPU: "
          f"BP within 1e-3 px on {100 * frac_bp:.3f}% of pixels (largest "
          f"{float(dbp.max()):.4g} px), CSBP equal on {100 * frac_cs:.3f}%",
          flush=True)
    if frac_bp < 0.99 or frac_cs < 0.99:
        _fail("stereo methods (b): the card disagrees with the CPU")

    # -- (c) the entry point on phase 11's tree
    bm = stereo_bm.block_matching_disparity_bm
    with open(nc_cfg) as fh:
        base_text = fh.read()
    for method in (3, 4):
        path = os.path.join(tmp, f"newcollege_method{method}.cfg")
        with open(path, "w") as fh:
            fh.write(base_text + f"ui.stereo_method = {method};\n")
        out = os.path.join(tmp, f"trajectory_method{method}.txt")
        args = [path, "--threaded", "--pipelined", "--pipeline-depth", "3",
                "--out", out]
        _cli(args + ["--max-frames", "6"])
        torch.cuda.synchronize()
        bm.launches = 0
        summ = _cli(args + ["--max-frames", str(BP_FRAMES)])
        launches = bm.launches
        fids, ate = _traj_ate(out, frames)
        print(f"stereo methods (c): stereo_method {method} through "
              f"stereo_slam.main (threaded, pipelined depth 3, loop closure "
              f"on): {summ['frames_processed']} frames processed, "
              f"{len(fids)} tracked, {summ['keyframes']} keyframes, ATE "
              f"{ate:.5f} m, {summ['frames_per_s']:.2f} frames/s (block "
              f"matching, phase 11 (a): {fps_a:.2f}); block-matching "
              f"launches {launches}", flush=True)
        if summ["frames_processed"] != BP_FRAMES or fids != list(
                range(BP_FRAMES)):
            _fail(f"stereo methods (c): method {method}: {len(fids)}/"
                  f"{BP_FRAMES} frames tracked")
        if summ["keyframes"] < 2:
            _fail(f"stereo methods (c): method {method}: fewer than 2 "
                  "keyframes")
        if not ate < BP_ATE_MAX[method]:
            _fail(f"stereo methods (c): method {method}: ATE {ate} m")
        if launches != 0:
            _fail(f"stereo methods (c): method {method}: {launches} "
                  "block-matching launches")
    return left, right


MONO_FRAMES = 120  # benchmarks/run_configs.py config 6
MONO_STEP = 0.01
MONO_ATE_FRAC = 0.06  # of the path length (tests/test_mono.py:88-97)
MONO_SYNC_FRAMES = 20
MONO_SPLIT = 80  # (b): frames before the checkpoint
MONO_STREAMS = 4
RESUME_TOL = 1e-5  # tests/test_mono.py test_checkpoint_resume
# the eager step is ~0.3 s of host time: 10 runs hold the script's time
MONO_TIMING_RUNS = 10
# the twin's mono test camera: the Sim3 scenes exist only at this size
MONO_SMALL_CAM = (130.0, (63.5, 47.5), (128, 96), 0.12)


def _centers(poses):
    """Camera centers (N, 3) of host poses (anything PoseRT takes)."""
    from scavislam_tpu_torch.core.lie import PoseRT
    out = []
    for T in poses:
        T = PoseRT.from_any(T)
        out.append(-np.asarray(T.R).T @ np.asarray(T.t))
    return np.stack(out)


def _sim3_ate(est_centers, gt_centers):
    """ATE after a closed-form Sim3 (Umeyama) alignment of the centers
    (pipeline.slam_system.ate_rmse_aligned on centers)."""
    from scavislam_tpu_torch.core.lie import umeyama_sim3
    s, R, t = umeyama_sim3(est_centers, gt_centers)
    r = gt_centers - (s * est_centers @ R.T + t)
    return float(np.sqrt((r ** 2).sum(axis=1).mean()))


def _tum_centers(path):
    """(frame ids, camera centers) of a TUM file (rows: id, t_wc, q)."""
    rows = np.atleast_2d(np.loadtxt(path))
    return rows[:, 0].astype(int), rows[:, 1:4]


def _mono_cli(args):
    """apps/mono_vo.main with its JSON summary captured; returns it."""
    from scavislam_tpu_torch.apps import mono_vo
    with contextlib.redirect_stdout(io.StringIO()):
        return mono_vo.main(args)


def _mono_run(fe, frames, pipelined):
    """Frames 1.. through `fe` (after process_first_frame(frames[0])).
    Returns (the failed frame id or None, seconds from the first dispatch
    to the flush)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    failed = None
    for f in frames[1:]:
        if pipelined:
            r = fe.process_frame_pipelined(f)
            if r is not None and not r[0]:
                failed = r[2]
                break
        else:
            ok, _ = fe.process_frame(f)
            if not ok:
                failed = f["frame_id"]
                break
    if pipelined and failed is None:
        for ok, _, fid in fe.flush_pipeline():
            if not ok:
                failed = fid
                break
    torch.cuda.synchronize()
    return failed, time.perf_counter() - t0


def _phase_mono(cam, cfg, dev, tmp):
    """Phase 13: the monocular mode. Returns the block-matching launches it
    made (0 expected) and a call of (a)'s mono_step for the profile."""
    from types import SimpleNamespace

    from scavislam_tpu_torch.core.camera import StereoCamera
    from scavislam_tpu_torch.io.filegrabber import FileGrabber
    from scavislam_tpu_torch.io.synthetic import SyntheticSequence
    from scavislam_tpu_torch.models.mono_frontend import MonoFrontend
    from scavislam_tpu_torch.models.mono_step import mono_step
    from scavislam_tpu_torch.ops import stereo_bm
    from scavislam_tpu_torch.utils.serialization import load_mono_system
    bm = stereo_bm.block_matching_disparity_bm
    bmb = stereo_bm.block_matching_disparity_bm_batched
    t_phase = time.perf_counter()

    # -- (a) config 6 in memory: 120 frames, uint8 left planes on the card
    seq = SyntheticSequence(cam, n_frames=MONO_FRAMES, step=MONO_STEP,
                            device=dev)
    frames = []
    for i in range(MONO_FRAMES):
        f = seq.frame(i)
        frames.append({"frame_id": i, "left": f["left"],
                       "right": f["right"], "left_dev": _u8(f["left"]),
                       "T_cw_gt": f["T_cw_gt"]})
    gt_c = _centers([f["T_cw_gt"] for f in frames])
    path_len = float(np.linalg.norm(np.diff(gt_c, axis=0), axis=1).sum())
    ate_max = MONO_ATE_FRAC * path_len
    warm = MonoFrontend(cam, cfg, device=dev)  # every program, once
    warm.process_first_frame(frames[0])
    for f in frames[1:6]:
        warm.process_frame_pipelined(f)
    warm.flush_pipeline()
    warm._add_new_keyframe(SimpleNamespace(pyr=warm.last_pyr))
    torch.cuda.synchronize()

    bm.launches = bmb.launches = 0
    fe = MonoFrontend(cam, cfg, device=dev)
    fe.pipeline_depth = 3
    fe.process_first_frame(frames[0])
    failed, dt = _mono_run(fe, frames, pipelined=True)
    launches = bm.launches + bmb.launches
    fps = (MONO_FRAMES - 1) / dt
    captures, replays = fe._step.captures, fe._step.replays
    fids = [fid for fid, _ in fe.trajectory]
    ate = _sim3_ate(_centers([T for _, T in fe.trajectory]), gt_c[fids])
    # the eager step alone, on the run's final state and last frame
    cand = fe._cand_device(fe._collect_candidates())
    R, t = fe._pose_dev()
    args = (frames[-1]["left_dev"], R, t, fe._actkey_dev(), fe.poses,
            fe.points, fe.Lam, cand, fe._conv_dev, fe._pw_dev,
            fe._cam_params, fe._cam_statics, fe.levels,
            float(cfg.ui.max_reproj_error), 0.18)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = mono_step(*args)
        synced = "none"
    except RuntimeError as e:
        synced = f"{type(e).__name__}: {e}"
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if synced != "none":
        eager = mono_step(*args)
    torch.cuda.synchronize()
    walls = []
    for _ in range(MONO_TIMING_RUNS):
        t0 = time.perf_counter()
        mono_step(*args)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    ms_ev = _cuda_ms(lambda: mono_step(*args), MONO_TIMING_RUNS)
    graph, captured = _graph_of(lambda: mono_step(*args))
    graph.replay()
    torch.cuda.synchronize()
    same = (torch.equal(captured.packed, eager.packed)
            and torch.equal(captured.Lam, eager.Lam)
            and torch.equal(captured.points.psi, eager.points.psi))
    ms_g = _cuda_ms(graph.replay, TIMING_RUNS)
    del graph
    # the synchronous path on the first frames, against the pipelined run
    fe_s = MonoFrontend(cam, cfg, device=dev)
    fe_s.process_first_frame(frames[0])
    failed_s, _ = _mono_run(fe_s, frames[:MONO_SYNC_FRAMES], pipelined=False)
    fid_s = [fid for fid, _ in fe_s.trajectory]
    ate_s = _sim3_ate(_centers([T for _, T in fe_s.trajectory]), gt_c[fid_s])
    head = [(fid, T) for fid, T in fe.trajectory if fid < MONO_SYNC_FRAMES]
    ate_p = _sim3_ate(_centers([T for _, T in head]),
                      gt_c[[fid for fid, _ in head]])
    print(f"mono (a): config 6, {MONO_FRAMES} frames at {cam.size[0]}x"
          f"{cam.size[1]} (step {MONO_STEP}, uint8 left planes on the card), "
          f"MonoFrontend pipelined at depth 3: {len(fids)}/{MONO_FRAMES} "
          f"frames in the trajectory, {fe.next_kf} keyframes, Sim3 ATE "
          f"{ate:.5f} m (bar {ate_max:.4f} m = {MONO_ATE_FRAC} x path "
          f"{path_len:.3f} m), {fps:.2f} frames/s over frames 1.."
          f"{MONO_FRAMES - 1}; the frontend's step graph: {captures} "
          f"capture, {replays} replays; block-matching launches {launches} "
          f"({launches / MONO_FRAMES:.0f} per frame); eager mono_step "
          f"{float(np.median(walls)):.3f} ms wall, {ms_ev:.3f} ms between "
          f"CUDA events (medians of {MONO_TIMING_RUNS}); synchronizing "
          f"calls in the step: {synced}; as a CUDA graph {ms_g:.3f} ms per "
          f"replay, replay torch.equal to the "
          f"eager step {same}; synchronous first {MONO_SYNC_FRAMES} frames: "
          f"{len(fid_s)} in the trajectory, ATE {ate_s:.5f} m against the "
          f"pipelined run's {ate_p:.5f} m on the same frames", flush=True)
    if failed is not None or fids != list(range(MONO_FRAMES)):
        _fail(f"mono (a): tracking failed at frame {failed} "
              f"({len(fids)} frames in the trajectory)")
    if fe.next_kf < 2:
        _fail("mono (a): fewer than 2 keyframes")
    if captures != 1 or replays != MONO_FRAMES - 2:
        _fail(f"mono (a): the frontend's step graph captured {captures} "
              f"times and replayed {replays} times over {MONO_FRAMES - 1} "
              "steps")
    if not ate < ate_max:
        _fail(f"mono (a): Sim3 ATE {ate} m over the bar {ate_max} m")
    if synced != "none":
        _fail(f"mono (a): the step synchronized ({synced})")
    if not same:
        _fail("mono (a): the graph replay differs from the eager step")
    if failed_s is not None or len(head) != len(fid_s):
        _fail(f"mono (a): synchronous run failed at {failed_s} or "
              f"{len(fid_s)} != {len(head)} frames")
    if not ate_p < max(2.0 * ate_s, 0.02):
        _fail(f"mono (a): pipelined ATE {ate_p} m against synchronous "
              f"{ate_s} m on the first {MONO_SYNC_FRAMES} frames")

    # -- (b) the user's entry point: mono_vo on a New College tree
    root = os.path.join(tmp, "mono_newcollege")
    os.makedirs(root)
    nc_cfg = _write_newcollege(root, frames, cfg)
    ck = os.path.join(tmp, "mono_checkpoint.npz")
    t1p = os.path.join(tmp, "mono_traj_1.txt")
    flags = ["--loop-close", "--window-ba", "--dwo", "--pipelined",
             "--pipeline-depth", "3"]
    t0 = time.perf_counter()
    s1 = _mono_cli([nc_cfg, *flags, "--max-frames", str(MONO_SPLIT),
                    "--save-system", ck, "--out", t1p])
    wall1 = time.perf_counter() - t0
    fid1, c1 = _tum_centers(t1p)
    ate1 = _sim3_ate(c1, gt_c[fid1])
    # resume on the rest of the tree, synchronously (deterministic), and
    # the same resume in process from the same files
    with open(nc_cfg) as fh:
        rest_cfg = os.path.join(tmp, "mono_rest.cfg")
        with open(rest_cfg, "w") as out:
            out.write(fh.read() + f"framepipe.skip_imgs = {MONO_SPLIT};\n")
    t2p = os.path.join(tmp, "mono_traj_2.txt")
    s2 = _mono_cli([rest_cfg, "--load-system", ck, "--out", t2p])
    _, c2 = _tum_centers(t2p)
    n_saved = len(fid1)
    resumed = c2[n_saved:]
    ref = load_mono_system(ck, cam, cfg, device=dev)
    grab = FileGrabber(root, base_pattern=".*rectified.*", fmt="pnm",
                       right_img=False, skip=MONO_SPLIT)
    try:
        for f in grab:
            ok, _ = ref.process_frame(f)
            if not ok:
                _fail(f"mono (b): the in-process resume failed at "
                      f"{f['frame_id']}")
    finally:
        grab.close()
    ref_last = _centers([ref.trajectory[-1][1]])[0]
    resume_err = float(np.abs(resumed[-1] - ref_last).max())
    gap = float(np.linalg.norm(resumed[0] - c1[-1]))
    all_c = np.concatenate([c1, resumed])
    all_f = np.concatenate([fid1, MONO_SPLIT + np.arange(len(resumed))])
    ate12 = _sim3_ate(all_c, gt_c[all_f])
    print(f"mono (b): mono_vo.main {' '.join(flags)} on the {MONO_FRAMES}-"
          f"frame New College tree, frames 0..{MONO_SPLIT - 1} then "
          f"--save-system: {s1['frames']} frames, {s1['keyframes']} "
          f"keyframes, {s1['converged_points']} converged points, loop "
          f"{s1.get('loop')}, {s1['frames'] / wall1:.2f} frames/s with the "
          f"grabber's device prefetch (summary: {s1['fps']}), Sim3 ATE "
          f"{ate1:.5f} m; --load-system on frames {MONO_SPLIT}.."
          f"{MONO_FRAMES - 1}: {s2['frames']} frames, {len(resumed)} new "
          f"poses, first resumed center {gap:.4f} m from the saved last "
          f"one, last resumed pose {resume_err:.2e} m from the in-process "
          f"resume (tolerance {RESUME_TOL}), Sim3 ATE over both runs "
          f"{ate12:.5f} m (bar {ate_max:.4f} m)", flush=True)
    if s1["frames"] != MONO_SPLIT or len(fid1) != MONO_SPLIT:
        _fail(f"mono (b): {s1['frames']} frames, {len(fid1)} poses")
    if s1["converged_points"] <= 50:
        _fail(f"mono (b): {s1['converged_points']} converged points")
    if not (ate1 < ate_max and ate12 < ate_max):
        _fail(f"mono (b): Sim3 ATE {ate1} / {ate12} m over {ate_max} m")
    if s2["frames"] != MONO_FRAMES - MONO_SPLIT or len(resumed) != s2[
            "frames"]:
        _fail(f"mono (b): the resume ran {s2['frames']} frames")
    if not resume_err <= RESUME_TOL:
        _fail(f"mono (b): resumed pose {resume_err} m from the in-process "
              "resume")

    # -- (c) the Sim3 path at the twin's 128x96 (its scenes exist only
    # there): the loop-closure scene, the kidnap, the drift pose graph
    from scavislam_tpu_torch.core.lie import SE3
    from scavislam_tpu_torch.models import mono_loop
    from scavislam_tpu_torch.models.map_store import MAX_POINTS
    small = StereoCamera.create(*MONO_SMALL_CAM)
    sseq = SyntheticSequence(small, n_frames=14, kind="forward_arc",
                             step=0.035, device=dev)
    sfr = [sseq.frame(i) for i in range(14)]
    sfe = MonoFrontend(small, device=dev)
    sfe.process_first_frame(sfr[0])
    for f in sfr[1:8]:
        if not sfe.process_frame(f)[0]:
            _fail("mono (c): the loop scene lost tracking")
    kf1 = sfe._new_keyframe_id()  # a second keyframe over the same corners
    sfe.poses = sfe.poses.set(kf1, SE3(torch.as_tensor(sfe._R_cw),
                                       torch.as_tensor(sfe._t_cw)))
    sfe.pose_np[kf1] = (sfe._R_cw.copy(), sfe._t_cw.copy())
    sfe.covis[kf1] = {0: 100}
    sfe.covis[0][kf1] = 100
    sfe._spawn(sfe.last_pyr, kf1, None)
    sfe.actkey_id = kf1
    for f in sfr[8:]:
        if not sfe.process_frame(f)[0]:
            _fail("mono (c): the loop scene lost tracking")
    pr = mono_loop.make_mono_place_recognizer(sfe, score_thr=0.05,
                                              min_inliers=10)
    pr.add_location({"kf_id": 0, "img": sfr[0]["left"], "disp": None,
                     "exclude": {0}})
    t0 = time.perf_counter()
    det = pr.add_location({"kf_id": kf1, "img": sfr[7]["left"],
                           "disp": None, "exclude": {kf1}})
    det_ms = 1e3 * (time.perf_counter() - t0)
    drift = 1.3
    s_pp = np.ones(MAX_POINTS, np.float32)
    s_pp[sfe._meta_anchor == kf1] = 1.0 / drift
    sfe.points = sfe.points._replace(psi=mono_loop._regauge_psi(
        sfe.points.psi, torch.as_tensor(s_pp, device=dev)))
    R1, t1 = sfe.pose_np[kf1]
    t1d = (t1 * drift).astype(np.float32)
    sfe.pose_np[kf1] = (R1, t1d)
    sfe.poses = sfe.poses.set(kf1, SE3(torch.as_tensor(R1),
                                       torch.as_tensor(t1d)))
    sfe._t_cw = (sfe._t_cw * drift).astype(np.float32)
    S_d, n_d = mono_loop.estimate_sim3(sfe, kf1, 0, min_inliers=10)
    t0 = time.perf_counter()
    scales = (mono_loop.close_loop_sim3(sfe, kf1, 0, S_d)
              if S_d is not None else {})
    close_ms = 1e3 * (time.perf_counter() - t0)
    # the kidnap: back at frame 1 with a corrupted yaw belief
    kfe = MonoFrontend(small, device=dev)
    kfe.process_first_frame(sfr[0])
    for f in sfr[1:12]:
        if not kfe.process_frame(f)[0]:
            _fail("mono (c): the kidnap scene lost tracking")
    kpr = mono_loop.make_mono_place_recognizer(kfe, score_thr=0.05)
    kpr.add_location({"kf_id": 0, "img": sfr[0]["left"], "disp": None,
                      "exclude": {0}})
    yaw = SE3.exp(torch.tensor([0, 0, 0, 0.0, 0.7, 0.0]))
    kfe._R_cw = yaw.R.numpy() @ kfe._R_cw
    kfe._dev_R_cw = kfe._dev_t_cw = None
    lost = not kfe.process_frame(sfr[1])[0]
    reloc = kfe.relocalize(kpr, sfr[1])
    reloc_err = float(np.linalg.norm(kfe._t_cw - sfr[1]["T_cw_gt"].t.numpy()))
    after = kfe.process_frame(sfr[2])[0]
    g_err, g_ms, g_chi2 = _sim3_graph_check(dev)
    print(f"mono (c): 128x96 loop scene: detected "
          f"{None if det is None else (det.loop_id, det.inliers)} "
          f"(add_location {det_ms:.1f} ms wall), scale "
          f"{None if det is None else round(float(det.S_query_from_loop.s), 4)}"
          f"; after a 1.3x drift on keyframe {kf1}: Sim3 scale "
          f"{None if S_d is None else round(float(S_d.s), 4)} ({n_d} "
          f"inliers), close_loop_sim3 re-gauge {scales.get(kf1)} "
          f"({close_ms:.1f} ms wall); kidnap: lost {lost}, relocalized "
          f"{reloc} at {reloc_err:.4f} m, next frame tracked {after}; Sim3 "
          f"pose graph (12-node drift loop, 12 iterations) card against "
          f"CPU {g_err:.2e}, chi2 {g_chi2[0]:.4f} -> {g_chi2[1]:.5f}, "
          f"{g_ms:.1f} ms wall per solve", flush=True)
    if det is None or det.loop_id != 0:
        _fail(f"mono (c): no loop detected ({det})")
    if S_d is None or not abs(float(S_d.s) - drift) < 0.12 * drift:
        _fail(f"mono (c): the drifted Sim3 was not found ({S_d}, {n_d})")
    if not scales.get(kf1, 0.0) > 1.05 or not np.isfinite(sfe._t_cw).all():
        _fail(f"mono (c): close_loop_sim3 re-gauge {scales}")
    if not (lost and reloc and reloc_err < 0.15 and after):
        _fail(f"mono (c): kidnap lost {lost} relocalized {reloc} err "
              f"{reloc_err} next {after}")
    if not g_err <= 1e-4:
        _fail(f"mono (c): Sim3 pose graph card against CPU {g_err}")

    # -- (d) the batched step: 4 streams at 512x384 against 4 single calls
    from scavislam_tpu_torch.parallel.multistream import (
        build_multistream_mono,
        stack_streams,
        stream_slice,
    )
    fes, imgs = [], []
    for s in range(MONO_STREAMS):
        q = SyntheticSequence(cam, n_frames=3, step=MONO_STEP * (1 + s),
                              device=dev)
        f_s = MonoFrontend(cam, cfg, device=dev)
        f_s.process_first_frame(q.frame(0))
        if not f_s.process_frame(q.frame(1))[0]:
            _fail(f"mono (d): stream {s} lost tracking")
        fes.append(f_s)
        imgs.append(_u8(q.frame(2)["left"]))
    cands = [f_s._cand_device(f_s._collect_candidates()) for f_s in fes]
    step = build_multistream_mono(None, fes[0]._cam_params,
                                  fes[0]._cam_statics, fes[0].levels)
    poses = [f_s._pose_dev() for f_s in fes]
    bargs = (torch.stack(imgs), torch.stack([p[0] for p in poses]),
             torch.stack([p[1] for p in poses]),
             torch.stack([f_s._actkey_dev() for f_s in fes]),
             stack_streams([f_s.poses for f_s in fes]),
             stack_streams([f_s.points for f_s in fes]),
             torch.stack([f_s.Lam for f_s in fes]), torch.stack(cands),
             torch.stack([f_s._conv_dev for f_s in fes]),
             torch.stack([f_s._pw_dev for f_s in fes]))
    (graph,) = step.graphs
    step(*bargs)  # the capture; its result is the warm-up's
    out = step(*bargs)  # one replay: the B streams' vmapped program
    eager = step.program(*bargs)
    replay_eq = all(torch.equal(x, y) for x, y in zip(_leaves(out),
                                                      _leaves(eager)))
    C = cands[0].shape[0]
    head = 34 + 4 * C  # pose, counts, gates, observations

    def leaves(o):
        return {"pose": o.packed[:24], "obs": o.packed[34 + 2 * C:head],
                "info": o.packed[head:], "psi": o.points.psi, "Lam": o.Lam}

    errs, gates, spreads = [], True, []
    singles = []
    for s, f_s in enumerate(fes):
        singles.append((imgs[s], *poses[s], f_s._actkey_dev(), f_s.poses,
                        f_s.points, f_s.Lam, cands[s], f_s._conv_dev,
                        f_s._pw_dev, f_s._cam_params, f_s._cam_statics,
                        f_s.levels))
        ref = mono_step(*singles[-1])
        spreads.append(_rounding_spread(mono_step, singles[-1], MONO_STATE,
                                        leaves))
        p, q = out.packed[s], ref.packed
        got, want = leaves(stream_slice(out, s)), leaves(ref)
        d = {k: float(torch.abs(got[k] - want[k]).max()) for k in got}
        bar = {k: max(MONO_LANE_TOL, LANE_WITNESS_MARGIN * v)
               for k, v in spreads[-1].items()}
        ok = (all(d[k] <= bar[k] for k in d)
              and torch.equal(p[24:27], q[24:27])
              and torch.equal(p[34:34 + 2 * C], q[34:34 + 2 * C]))
        errs.append((d, bar, ok))
        gates &= bool(torch.equal(out.gate[s], ref.gate))
    lane_line = "; ".join(
        "[" + " ".join(f"{k} {d[k]:.1e}/{bar[k]:.1e}" for k in d)
        + ("" if ok else " OVER") + "]" for d, bar, ok in errs)
    ms_b = _cuda_ms(lambda: step(*bargs), 5)
    ms_1 = _cuda_ms(lambda: [mono_step(*a) for a in singles], 3)
    tracked = [int(out.packed[s, 25]) for s in range(MONO_STREAMS)]
    print(f"mono (d): build_multistream_mono at B = {MONO_STREAMS}, "
          f"{cam.size[0]}x{cam.size[1]}, one CUDA graph replay "
          f"({graph.captures} capture, {graph.replays} replays): equal to "
          f"the eager vmapped program {replay_eq}; against {MONO_STREAMS} "
          f"mono_step calls, per stream [leaf |diff| / bar] "
          f"{lane_line} (counts, gates and matches equal; each leaf within "
          f"{MONO_LANE_TOL:g}, or {LANE_WITNESS_MARGIN:g} times the "
          f"single call's own move over {LANE_WITNESS_DRAWS} one-ulp moves "
          f"of its state where larger), gates equal {gates}, gated per "
          f"stream {tracked}; ms between "
          f"CUDA events {ms_b:.2f} per replay against {ms_1:.2f} for "
          f"{MONO_STREAMS} eager mono_step calls; phase 13 took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    if not replay_eq:
        _fail("mono (d): the replay differs from the eager vmapped program")
    if not (all(ok for _, _, ok in errs) and gates):
        _fail(f"mono (d): batched step differs {lane_line} gates {gates}")
    if min(tracked) < 15:
        _fail(f"mono (d): a stream gated {tracked}")
    return bm.launches + bmb.launches, lambda: mono_step(*args)


def _sim3_graph_check(dev):
    """The twin's 12-node drift loop (tests/test_sim3_mono.py) through
    optimize_sim3_pose_graph on the card and on the CPU: (largest node
    difference, wall ms per solve on the card, (chi2 first, last))."""
    from scavislam_tpu_torch.core.lie import SO3, Sim3
    from scavislam_tpu_torch.models.sim3_graph import optimize_sim3_pose_graph
    n = 12
    gt = []
    for k in range(n):
        a = 2 * np.pi * k / n
        R = SO3.exp(torch.tensor([0.0, a, 0.0])).R
        c = torch.tensor([np.cos(a), 0.0, np.sin(a)], dtype=torch.float32)
        gt.append(Sim3(R, -(R @ c), torch.tensor(1.0)))
    meas = [gt[k] @ gt[(k + 1) % n].inverse() for k in range(n)]
    meas = [Sim3(S.R, S.t, S.s * 1.04) for S in meas[:-1]] + [meas[-1]]
    est = [gt[0]]
    for k in range(n - 1):
        est.append(meas[k].inverse() @ est[-1])

    def stack(xs, d):
        return Sim3(torch.stack([x.R for x in xs]).to(d),
                    torch.stack([x.t for x in xs]).to(d),
                    torch.stack([x.s.reshape(()) for x in xs]).to(d))

    ei = np.arange(n)
    ej = (ei + 1) % n

    def solve(d):
        return optimize_sim3_pose_graph(
            stack(est, d), ei, ej, stack(meas, d),
            torch.ones(n, dtype=torch.bool, device=d), iters=12)

    solve(dev)  # warm-up
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_g, hist = solve(dev)
        walls.append(1e3 * (time.perf_counter() - t0))
    out_c, _ = solve("cpu")
    err = max(float(torch.abs(a.cpu() - b).max())
              for a, b in zip(out_g, out_c))
    return err, float(np.median(walls)), (hist[0], hist[-1])


VIEW_FRAMES = 20
# the dictionary corpus, cut from the shipped recipe's 8 scenes x 16 frames
# to 2 x 8 (recipe v2: 8 scenes of 8 frames, 64 images) for the script's time
DICT_SCENES, DICT_FRAMES = 2, 8
STATUS_KEYS = {"frame", "fps", "keyframes", "actkey", "loops_closed", "lost",
               "relocalizations", "parallax_thr", "debug_mode"}
MESH_TOL = 1e-4  # sharded BA against solve_ba, relative


def _decodes_to(path, img):
    """The PNG at `path` decodes (utils/png.py) to exactly `img`."""
    from scavislam_tpu_torch.utils.png import decode_png
    with open(path, "rb") as f:
        return np.array_equal(decode_png(f.read()), img)


def _counted_syncs(fn):
    """(fn(), synchronizing calls it made) from an idle card."""
    torch.cuda.synchronize()
    return _syncs_in(fn)


def _syncs_in(fn):
    """(fn(), synchronizing calls it made), counted under sync debug mode
    "warn"."""
    import warnings
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)


def _event_ms(fn, runs=5):
    """Median ms between CUDA events around fn() (which may synchronize
    itself, as a render's download does)."""
    fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _phase_viewers(cam, cfg, dev, frames, num_disp):
    """Phase 14 (a): the viewers on a SlamSystem's state on the card."""
    from scavislam_tpu_torch.apps import visualize as viz
    from scavislam_tpu_torch.apps.map3d import export_map_html
    from scavislam_tpu_torch.pipeline.slam_system import SlamSystem
    system = SlamSystem(cam, cfg, threaded=False, device=dev)
    system.frontend.keep_kf_images = True
    try:
        system.process_first_frame(frames[0])
        for f in frames[1:VIEW_FRAMES]:
            if not system.process_frame(f):
                _fail(f"viewers (a): tracking failed at {f['frame_id']}")
        system.finish()
    finally:
        system.shutdown()
    fe, g = system.frontend, system.backend.graph
    with tempfile.TemporaryDirectory() as out:
        rows, ok = [], True
        valid = (fe.last_disp > 0).cpu().numpy()
        for mode, name in enumerate(viz.DEBUG_MODES):
            for level in (0, 2):
                p = os.path.join(out, f"{name}_{level}.png")
                t0 = time.perf_counter()
                img, n_sync = _counted_syncs(lambda: viz.render_debug_image(
                    mode, level, fe, num_disp=num_disp, path=p))
                wall = 1e3 * (time.perf_counter() - t0)
                dms = _event_ms(lambda: viz.render_debug_image(
                    mode, level, fe, num_disp=num_disp))
                full = level == 0 or name in ("right", "color_disp")
                want = (384, 512, 3) if full else (96, 128, 3)
                good = (img.shape == want and n_sync == 1
                        and _decodes_to(p, img))
                if name == "color_disp":
                    good &= np.array_equal(img.max(-1) > 0, valid)
                ok &= good
                rows.append(f"{name}@{level} {img.shape[0]}x{img.shape[1]} "
                            f"{n_sync} sync {wall:.1f} wall ms "
                            f"{dms:.3f} device ms"
                            + ("" if good else " FAILED"))
        kf = max(fe.keyframe_map)
        timed = {}

        def run(name, fn):
            t0 = time.perf_counter()
            r = fn()
            timed[name] = 1e3 * (time.perf_counter() - t0)
            return r

        gts = [f["T_cw_gt"] for f in frames[:VIEW_FRAMES]]
        paths = {k: os.path.join(out, k) for k in
                 ("kf.png", "timing.png", "map.png", "map3d.html")}
        kf_img = run("keyframe view", lambda: viz.render_keyframe_view(
            fe, kf, path=paths["kf.png"]))
        t_img = run("timing plot", lambda: viz.render_timing_plot(
            system.per_mon, path=paths["timing.png"]))
        m_img = run("top-down map", lambda: viz.render_map_topdown(
            g, trajectory=system.trajectory, gt_poses=gts,
            path=paths["map.png"]))
        scene = run("map3d html", lambda: export_map_html(
            g, trajectory=system.trajectory, gt_poses=gts,
            path=paths["map3d.html"], actkey_id=fe.actkey_id))
        ok &= (kf_img.shape == (384, 512, 3) and t_img.shape == (360, 900, 3)
               and m_img.shape == (900, 900, 3)
               and all(_decodes_to(paths[k], im) for k, im in (
                   ("kf.png", kf_img), ("timing.png", t_img),
                   ("map.png", m_img)))
               and len(scene["kf_ids"]) == len(g.vertices)
               and len(scene["traj"]) == len(system.trajectory))
    print(f"viewers (a): SlamSystem unthreaded, {VIEW_FRAMES} frames at "
          f"512x384, {fe.next_kf} keyframes, {len(g.vertices)} graph "
          f"vertices; debug views (one download each, PNG round trip, "
          f"color_disp lit == disparity valid): " + "; ".join(rows)
          + "; wall ms " + ", ".join(f"{k} {v:.1f}" for k, v in timed.items())
          + f"; map3d scene {len(scene['kf_ids'])} keyframes, "
          f"{len(scene['points'])} points", flush=True)
    if not ok:
        _fail("viewers (a): a view failed its check")


def _phase_viewer_cli(nc_cfg, frames, fps_a, tmp):
    """Phase 14 (b): stereo_slam.main with every viewer flag on phase 11's
    tree, then mono_vo.main with its viewers on phase 13's. Returns the
    single-image kernel launches of the stereo run."""
    from scavislam_tpu_torch.ops import stereo_bm
    n = len(frames)
    base = os.path.join(tmp, "viewer_cli")
    wdir = os.path.join(base, "watch")
    ddir = os.path.join(base, "debug")
    os.makedirs(wdir)
    with open(os.path.join(wdir, "tunables.cfg"), "w") as fh:
        fh.write("debug_mode = 3\n")
    arts = {f: os.path.join(base, f) for f in
            ("map.png", "map3d.html", "timing.png", "kf.png")}
    out = os.path.join(base, "trajectory.txt")
    stereo_bm.block_matching_disparity_bm.launches = 0
    summ = _cli([nc_cfg, "--threaded", "--pipelined", "--pipeline-depth",
                 "3", "--viz", arts["map.png"], "--viz-html",
                 arts["map3d.html"], "--timing-plot", arts["timing.png"],
                 "--keyframe-view", arts["kf.png"], "--debug-mode", "6",
                 "--debug-every", "10", "--debug-out", ddir, "--watch", wdir,
                 "--watch-period", "0.5", "--out", out])
    launches = stereo_bm.block_matching_disparity_bm.launches
    fids, ate = _traj_ate(out, frames)
    debug = sorted(os.listdir(ddir)) if os.path.isdir(ddir) else []
    watched = [f for f in ("map.png", "map3d.html", "timing.png",
                           "status.json") if os.path.exists(
                               os.path.join(wdir, f))]
    with open(os.path.join(wdir, "status.json")) as fh:
        status = json.load(fh)
    written = [f for f, p in arts.items() if os.path.exists(p)]
    print(f"viewers (b): stereo_slam.main --threaded --pipelined "
          f"--pipeline-depth 3 with --viz --viz-html --timing-plot "
          f"--keyframe-view --debug-mode 6 --debug-every 10 --watch "
          f"(period 0.5 s): {len(fids)}/{n} tracked, {summ['keyframes']} "
          f"keyframes, ATE {ate:.5f} m, {summ['frames_per_s']:.2f} frames/s "
          f"(phase 11 (a), no viewers: {fps_a:.2f}); written {written}, "
          f"{len(debug)} debug PNGs, watch dir {watched}, status {status}; "
          f"kernel launches {launches} for {n} frames", flush=True)
    if fids != list(range(n)) or not ate < ATE_MAX:
        _fail(f"viewers (b): {len(fids)}/{n} tracked, ATE {ate} m")
    if launches != n:
        _fail(f"viewers (b): kernel launches {launches} != {n} frames")
    if (len(written) != len(arts) or len(watched) != 4
            or debug != [f"debug_{i:06d}.png" for i in range(0, n, 10)]):
        _fail("viewers (b): an artifact is missing")
    if (set(status) != STATUS_KEYS or not 0 <= status["frame"] < n
            or status["debug_mode"] != 3):
        _fail(f"viewers (b): status.json {status}")

    mono_cfg = os.path.join(tmp, "mono_newcollege", "newcollege.cfg")
    mdir = os.path.join(base, "mono")
    mwatch = os.path.join(mdir, "watch")
    marts = [os.path.join(mdir, "map.png"), os.path.join(mdir, "map3d.html"),
             os.path.join(mwatch, "map3d.html"),
             os.path.join(mwatch, "status.json")]
    os.makedirs(mdir)
    s = _mono_cli([mono_cfg, "--max-frames", "40", "--viz", marts[0],
                   "--viz-html", marts[1], "--watch", mwatch])
    mwritten = [os.path.relpath(p, mdir) for p in marts if os.path.exists(p)]
    print(f"viewers (b): mono_vo.main on 40 frames of phase 13's tree with "
          f"--viz --viz-html --watch: {s['frames']} frames, "
          f"{s['keyframes']} keyframes, written {mwritten}", flush=True)
    if len(mwritten) != len(marts) or s["frames"] != 40:
        _fail("viewers (b): mono_vo's artifacts are missing")
    return launches


def _phase_dictionary(dev, nc_root):
    """Phase 14 (c): create_dictionary on the card."""
    from scavislam_tpu_torch.apps import create_dictionary as cd
    from scavislam_tpu_torch.models.placerec import train_vocabulary
    with tempfile.TemporaryDirectory() as out:
        p = os.path.join(out, "vocab.npz")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cd.main(["--synthetic", "--corpus-scenes", str(DICT_SCENES),
                     "--corpus-frames", str(DICT_FRAMES), "--out", p])
        wall = time.perf_counter() - t0
        vocab = np.load(p)["vocab"]
        n_desc = int(re.search(r"clustering (\d+) descriptors",
                               buf.getvalue()).group(1))
        n_img = (DICT_SCENES + 4 + 2) * DICT_FRAMES  # recipe v2's scenes
        desc = cd.synthetic_corpus_descriptors(
            verbose=False, n_scenes=DICT_SCENES, frames_per_scene=DICT_FRAMES,
            device=dev)
        k = vocab.shape[0]
        ms = {it: _event_ms(lambda it=it: train_vocabulary(
            desc, k=k, iters=it, device=dev), runs=3) for it in (1, 11)}
        per_iter = (ms[11] - ms[1]) / 10
        bound = 1e3 * 2 * len(desc) * k * 128 / FP32_OPS_PER_S
        p2 = os.path.join(out, "vocab_dir.npz")
        with contextlib.redirect_stdout(io.StringIO()):
            cd.main([nc_root, "10", "64", "--pattern", r".*left\.pnm$",
                     "--out", p2])
        v2 = np.load(p2)["vocab"]
    norms = np.linalg.norm(vocab, axis=1)
    print(f"dictionary (c): create_dictionary.main --synthetic "
          f"--corpus-scenes {DICT_SCENES} --corpus-frames {DICT_FRAMES} at "
          f"512x384: {n_img} images, {n_desc} descriptors "
          f"({n_desc / n_img:.1f} per image), vocabulary {vocab.shape}, row "
          f"norms {norms.min():.6f}..{norms.max():.6f}, {wall:.2f} s wall; "
          f"train_vocabulary {per_iter:.3f} ms per Lloyd iteration (CUDA "
          f"events, 11 vs 1 iterations) beside its bound {bound:.3f} ms "
          f"(2 n k 128 flop at the fp32 peak, operations); directory mode on "
          f"10 left images: vocabulary {v2.shape}", flush=True)
    if vocab.shape != (4096, 128) or not np.allclose(norms, 1.0, atol=1e-3):
        _fail("dictionary (c): the vocabulary is not 4096 unit rows")
    if v2.shape != (64, 128) or not np.allclose(
            np.linalg.norm(v2, axis=1), 1.0, atol=1e-3):
        _fail("dictionary (c): the directory-mode vocabulary is wrong")


def _rel(a, b):
    """max |a - b| over max |b|."""
    b = b.float()
    return float((a.float() - b).abs().max()) / max(float(b.abs().max()),
                                                    1e-12)


def _phase_mesh(cam, cfg, dev, frames, graph, sys_u, ticks, gts, pool_ref):
    """Phase 14 (d): the mesh over the one card listed more than once.
    Returns the batched kernel launches of the sharded pool."""
    from scavislam_tpu_torch.core.lie import SE3
    from scavislam_tpu_torch.models.ba_solver import solve_ba
    from scavislam_tpu_torch.models.slam_graph import _unpack_problem
    from scavislam_tpu_torch.ops import stereo_bm
    from scavislam_tpu_torch.parallel.multistream import (
        build_multistream_step,
        build_sharded_ba,
        make_mesh,
        stream_slice,
    )
    from scavislam_tpu_torch.parallel.stream_pool import StreamPool

    def mesh(n, dp):
        return make_mesh(n, dp=dp, devices=[dev] * n)

    # -- the tracking step at (dp, sp) = (2, 1) and (1, 2)
    rng = np.random.RandomState(0)
    B, N = 2, 4096
    xyz = torch.as_tensor(np.stack([rng.randn(B, N) * 1.5, rng.randn(B, N),
                                    rng.rand(B, N) * 5 + 3], -1)
                          .astype(np.float32), device=dev)
    T = SE3.exp(torch.as_tensor(rng.randn(B, 6).astype(np.float32) * 0.1,
                                device=dev))
    obs = cam.map_uvu(torch.einsum("bij,bnj->bni", T.R, xyz)
                      + T.t[:, None])
    args = (torch.eye(3, device=dev).expand(B, 3, 3).contiguous(),
            torch.zeros((B, 3), device=dev), xyz, obs,
            torch.ones((B, N), device=dev),
            torch.ones((B, N), dtype=torch.bool, device=dev))
    cp = (cam.focal, cam.pp[0], cam.pp[1], cam.baseline)
    R1, t1, _ = build_multistream_step(None, cp, iters=5)(*args)
    step_err = {}
    for dp, sp in ((2, 1), (1, 2)):
        Rm, tm, _ = build_multistream_step(mesh(dp * sp, dp), cp,
                                           iters=5)(*args)
        step_err[(dp, sp)] = max(float((Rm - R1).abs().max()),
                                 float((tm - t1).abs().max()))

    # -- the sharded solve on phase 8's last packed problem, full caps
    cam_params, buf, caps = graph.last_problem
    prob, _ = _unpack_problem(buf, caps)
    ref = solve_ba(cam_params, prob, iters=2, huber=3.0)
    ba = {}
    for sp in (2, 4):
        step = build_sharded_ba(mesh(sp, 1), cam_params, iters=2)
        R2, t2, psi2, chi2 = step(prob)
        errs = [_rel(R2, ref[0]), _rel(t2, ref[1]), _rel(psi2, ref[2]),
                abs(float(chi2) - float(ref[3].chi2_final))
                / max(float(ref[3].chi2_final), 1e-12)]
        try:
            dms = _cuda_ms(_graph_of(lambda step=step: step(prob))[0].replay,
                           TIMING_RUNS)
        except Exception as e:  # a report, not a check
            dms = f"not measured ({type(e).__name__}: {e})"
        ba[sp] = (errs, dms)
    try:
        ref_ms = _cuda_ms(_graph_of(lambda: solve_ba(
            cam_params, prob, iters=2, huber=3.0))[0].replay, TIMING_RUNS)
    except Exception as e:  # a report, not a check
        ref_ms = f"not measured ({type(e).__name__}: {e})"

    # -- the pool over a dp = 2 mesh on phase 7's ticks
    stereo_bm.block_matching_disparity_bm.launches = 0
    stereo_bm.block_matching_disparity_bm_batched.launches = 0
    pool = StreamPool(cam, cfg, n_streams=N_STREAMS, mesh=mesh(2, 2),
                      pipeline_depth=2)
    t0 = time.perf_counter()
    pool.process_first_frames(ticks[0])
    for tick in ticks[1:]:
        pool.process_frames(tick)
    pool.finish()
    torch.cuda.synchronize()
    pool_s = time.perf_counter() - t0
    launches_b = stereo_bm.block_matching_disparity_bm_batched.launches
    launches_1 = stereo_bm.block_matching_disparity_bm.launches
    pool_graphs = [(g.captures, g.replays) for g in pool.step.graphs]
    pool_err = 0.0
    same_fids = True
    for s in range(N_STREAMS):
        a, b = pool.trajectories[s], pool_ref["traj"][s]
        same_fids &= [f for f, _ in a] == [f for f, _ in b]
        pool_err = max([pool_err] + [float(np.abs(np.asarray(x.t)
                                                  - np.asarray(y.t)).max())
                                     for (_, x), (_, y) in zip(a, b)])
    # one tick's lanes first: the two B = 4 programs against phase 7's
    # B = 8 program on phase 7 (b)'s state
    tick = pool.step(*pool_ref["args"])
    lanes = [_lane_diff(tick, s, stream_slice(pool_ref["lanes"], s),
                        pool_ref["bars"][s]) for s in range(N_STREAMS)]
    lanes_equal = all(torch.equal(x, y) for x, y in
                      zip(_leaves(tick), _leaves(pool_ref["lanes"])))
    ates_m = [_ate([T for _, T in t], [gts[s][i] for i, _ in t])
              for s, t in enumerate(pool.trajectories)]
    kfs_m = pool.keyframe_counts()
    # phase 15's rule where the trajectories part only because the B = 4
    # and B = 8 programs round differently
    ate_rel = max(abs(a - b) / b for a, b in zip(ates_m, pool_ref["ates"]))
    pool_ok = (pool_err <= 1e-5 or (
        not lanes_equal and all(ok and g for _, _, _, ok, g in lanes)
        and ate_rel <= PARITY_REL_TOL and kfs_m == pool_ref["kfs"]))

    # -- phase 8's unthreaded run with the solve sharded over 2
    stereo_bm.block_matching_disparity_bm.launches = 0
    r = _run_system(cam, cfg, dev, frames, threaded=False, pipelined=False,
                    solve_mesh=mesh(2, 1))
    launches_s = stereo_bm.block_matching_disparity_bm.launches
    print(f"mesh (d): one card listed 2-4 times (cross-card copies not "
          f"measured); tracking step B={B} N={N} max |diff| against "
          f"mesh=None "
          + ", ".join(f"(dp, sp) = {k}: {v:.2e}" for k, v in step_err.items())
          + f"; build_sharded_ba on phase 8's last problem at caps {caps}, "
          f"relative R/t/psi/chi2 error against solve_ba "
          + "; ".join(f"sp={sp}: {', '.join(f'{e:.2e}' for e in errs)}, "
                      f"device ms {dms if isinstance(dms, str) else f'{dms:.3f}'}"
                      for sp, (errs, dms) in ba.items())
          + f" (solve_ba alone "
          f"{ref_ms if isinstance(ref_ms, str) else f'{ref_ms:.3f}'} device "
          f"ms, CUDA graph replays); pool of {N_STREAMS} streams over dp = 2 "
          f"for {len(ticks)} ticks: alive {sum(pool.alive)}/{N_STREAMS}, "
          f"trajectories max |t diff| against phase 7 {pool_err:.2e} m, "
          f"ATE relative difference {ate_rel:.2e}, keyframes {kfs_m} "
          f"(phase 7: {pool_ref['kfs']}); tick {POOL_STATE_TICKS}'s state "
          f"through the two B = 4 programs against phase 7's B = 8: equal "
          f"{lanes_equal}, per stream [|R diff| |t diff| packed max] "
          f"{_lane_line(lanes)}; (captures, replays) per shard "
          f"{pool_graphs}; batched launches {launches_b}, single-image "
          f"launches {launches_1}, {pool_s:.2f} s; unthreaded system with "
          f"the solve "
          f"on a 2-shard mesh: {r['tracked']}/{r['frames']} tracked, "
          f"{r['keyframes']} keyframes (phase 8: {sys_u['keyframes']}), "
          f"{r['solves']} solves (last chi2 {r['chi2'][0]:.3f} -> "
          f"{r['chi2'][1]:.3f}), ATE {r['ate']:.5f} m (phase 8: "
          f"{sys_u['ate']:.5f}), kernel launches {launches_s}", flush=True)
    if max(step_err.values()) > 1e-5:
        _fail(f"mesh (d): the sharded tracking step differs {step_err}")
    if any(max(errs) > MESH_TOL for errs, _ in ba.values()):
        _fail("mesh (d): the sharded solve differs from solve_ba")
    if (not all(pool.alive) or not same_fids or not pool_ok
            or launches_b != 2 * len(ticks) or launches_1 != 0
            or pool_graphs != [(1, len(ticks) - 1)] * 2):
        _fail("mesh (d): the sharded pool differs from phase 7's")
    if (r["failed"] is not None or r["tracked"] != r["frames"]
            or abs(r["keyframes"] - sys_u["keyframes"]) > 1
            or abs(r["ate"] - sys_u["ate"]) > 0.01 * sys_u["ate"]
            or r["solves"] < 1 or not r["chi2"][1] <= r["chi2"][0]):
        _fail("mesh (d): the system with a sharded solve left its bars")
    return launches_b


PARITY_REL_TOL = 0.01  # the north star: ATE within 1% relative
PARITY_POS_M = 1e-4  # positions further apart than this: the runs diverged
SPIN_COUNTS = ("keyframes", "solves", "metric_edges", "appearance_edges",
               "closed_loops")
WANDER_COUNTS = ("keyframes", "solves")
PARITY_MONO_FRAMES = 40  # config 6's forward arc, cut from 120
# phase 8's wander cut from 80 frames to 40 for the script's 1,200 s: with
# 80, run after each other, a whole run took 698-1,086 s on an NVIDIA H100
# 80GB HBM3 (700 W) machine, its CPU runs the slowest part
PARITY_WANDER_FRAMES = 40
# The CPU link: the port against the JAX package, both on a CPU, on the
# spin read from one PNM tree by both (tests/test_torch_system_parity.py,
# slow): the port's ATE relative difference as that test measured it.
JAX_LINK = {"spin method 2": "0.52% (tests/test_torch_system_parity.py, "
            "on a CPU)",
            "spin method 1": "0.67% (tests/test_torch_system_parity.py, "
            "on a CPU)",
            "wander 512x384": "not measured (the JAX package is not run "
            "at this size on a CPU)"}


class CpuDraws:
    """The place recognizer's RANSAC draws from one CPU generator seeded 42,
    moved to `device`. Installed as `place_recognizer.hypotheses` in a run
    on the card and in one on the CPU, both score the same hypotheses (a
    card's own generator is Philox, the CPU's MT19937)."""

    def __init__(self, device, seed=42):
        self.device = torch.device(device)
        self.generator = torch.Generator().manual_seed(seed)

    def draw(self, n):
        """The next (NUM_HYPOTHESES, 3) raw draws in [0, n), on the CPU."""
        from scavislam_tpu_torch.models.placerec import NUM_HYPOTHESES
        from scavislam_tpu_torch.ops.ransac import draw_hypotheses
        return draw_hypotheses(n, NUM_HYPOTHESES, self.generator, "cpu")

    def __call__(self, n):
        return self.draw(n).to(self.device)


def parity_frames(cam, n, **seq_kw):
    """n frames rendered once on the CPU by the port's renderer and
    quantized as benchmarks/tpu_cpu_parity.py does (clip(x, 0, 1) * 255 +
    0.5): host uint8 arrays that a run on any device takes (the card's
    uploads them), with the ground truth."""
    from scavislam_tpu_torch.io.synthetic import SyntheticSequence
    seq = SyntheticSequence(cam, n_frames=n, device="cpu", **seq_kw)
    out = []
    for i in range(n):
        f = seq.frame(i)
        out.append({"frame_id": i, "left": _u8(f["left"]).numpy(),
                    "right": _u8(f["right"]).numpy(),
                    "T_cw_gt": f["T_cw_gt"]})
    return out


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _traj_summary(trajectory, frames, seconds, dev):
    """The (frame id, pose) pairs of a run as {id: (R, t) float64} and the
    ATE against the frames' ground truth (SlamSystem's own ate_rmse)."""
    from scavislam_tpu_torch.core.lie import PoseRT
    from scavislam_tpu_torch.pipeline.slam_system import ate_rmse
    gt = {f["frame_id"]: f["T_cw_gt"] for f in frames}
    traj = {}
    for fid, T in trajectory:
        if fid in gt:
            T = PoseRT.from_any(T)
            traj[fid] = (np.asarray(T.R, np.float64),
                         np.asarray(T.t, np.float64))
    ids = sorted(traj)
    ate = ate_rmse([(i, PoseRT(*traj[i])) for i in ids],
                   [gt[i] for i in ids]) if ids else float("inf")
    return {"device": dev.type, "frames": len(frames), "tracked": len(ids),
            "trajectory": traj, "ate": ate, "seconds": seconds}


def parity_run(cam, cfg, dev, frames, loop_closure=True):
    """One SlamSystem run over `frames` on `dev`, unthreaded, synchronous
    and pr_lossless as benchmarks/tpu_cpu_parity.py runs it (every device
    executes the same order of events), the recognizer drawing CpuDraws.
    Returns the run's counts, trajectory, ATE and wall seconds."""
    from scavislam_tpu_torch.models.slam_graph import APPEARANCE, METRIC
    from scavislam_tpu_torch.pipeline.slam_system import SlamSystem
    dev = torch.device(dev)
    system = SlamSystem(cam, cfg, threaded=False,
                        enable_loop_closure=loop_closure, pipelined=False,
                        pr_lossless=loop_closure, device=dev)
    if system.place_recognizer is not None:
        system.place_recognizer.hypotheses = CpuDraws(dev)
    _sync(dev)
    t0 = time.perf_counter()
    try:
        system.process_first_frame(dict(frames[0]))
        for f in frames[1:]:
            if not system.process_frame(dict(f)):
                break
        system.finish()
        _sync(dev)
    finally:
        system.shutdown()
    out = _traj_summary(system.trajectory, frames, time.perf_counter() - t0,
                        dev)
    g = system.backend.graph
    types = [e.edge_type for e in g.edges.values()]
    out.update(keyframes=system.frontend.next_kf, solves=len(g.solve_log),
               metric_edges=types.count(METRIC),
               appearance_edges=types.count(APPEARANCE),
               closed_loops=len(system.closed_loops),
               counters=dict(sorted(system.backend.counters.items())))
    return out


def parity_compare(a, b, counts):
    """Run `a` against run `b` on the same frames: the ATE's relative
    difference (to b's), the RMSE between the two trajectories'
    translations (benchmarks/tpu_cpu_parity.py's traj_rmse_m), the first
    frame whose camera positions lie more than PARITY_POS_M apart,
    whether the trajectories are bit-equal, and the misses of the north
    star: a run that did not track every frame, an ATE more than
    PARITY_REL_TOL apart, a count of `counts` that differs."""
    ta, tb = a["trajectory"], b["trajectory"]
    common = sorted(set(ta) & set(tb))
    dt = np.stack([ta[i][1] - tb[i][1] for i in common]) if common else None
    diverged = next((i for i in common if np.linalg.norm(
        ta[i][0].T @ ta[i][1] - tb[i][0].T @ tb[i][1]) > PARITY_POS_M), None)
    rel = abs(a["ate"] - b["ate"]) / max(b["ate"], 1e-12)
    misses = [f"{r['device']} run tracked {r['tracked']}/{r['frames']}"
              for r in (a, b) if r["tracked"] != r["frames"]]
    if not rel <= PARITY_REL_TOL:
        misses.append(f"ATE {a['ate']:.6f} against {b['ate']:.6f} m: "
                      f"{100 * rel:.3f}% apart")
    misses += [f"{k} {a[k]} against {b[k]}" for k in counts if a[k] != b[k]]
    return {
        "ate_rel_diff": rel,
        "traj_rmse_m": (float(np.sqrt((dt ** 2).sum(1).mean()))
                        if dt is not None else float("inf")),
        "first_diverged": diverged,
        "bit_equal": (set(ta) == set(tb) and all(
            np.array_equal(ta[i][0], tb[i][0])
            and np.array_equal(ta[i][1], tb[i][1]) for i in common)),
        "misses": misses,
    }


def _parity_line(name, a, b, cmp, counts, link=None):
    print(f"parity {name}: {a['device']} {a['tracked']}/{a['frames']} "
          f"tracked, ATE {a['ate']:.6f} m, {a['seconds']:.1f} s; "
          f"{b['device']} {b['tracked']}/{b['frames']}, ATE {b['ate']:.6f} "
          f"m, {b['seconds']:.1f} s; ATE relative difference "
          f"{100 * cmp['ate_rel_diff']:.4f}% (limit "
          f"{100 * PARITY_REL_TOL:.0f}%); "
          + ", ".join(f"{k} {a[k]}/{b[k]}" for k in counts)
          + f"; traj_rmse_m {cmp['traj_rmse_m']:.3e}, first frame with "
          f"positions > {PARITY_POS_M:g} m apart {cmp['first_diverged']}, "
          f"bit-equal {cmp['bit_equal']}"
          + ("" if link is None else f"; JAX link: port CPU against JAX CPU "
             f"{link}")
          + (f"; MISSES {cmp['misses']}" if cmp["misses"] else ""),
          flush=True)


def parity_mono(cam, cfg, dev, frames):
    """MonoFrontend over `frames` on `dev`, synchronous (it draws no random
    number: its loop closure lives in mono_vo). Returns the run's
    keyframes, trajectory, Sim3-aligned ATE and wall seconds."""
    from scavislam_tpu_torch.models.mono_frontend import MonoFrontend
    dev = torch.device(dev)
    fe = MonoFrontend(cam, cfg, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    fe.process_first_frame(dict(frames[0]))
    for f in frames[1:]:
        ok, _ = fe.process_frame(dict(f))
        if not ok:
            break
    _sync(dev)
    out = _traj_summary(fe.trajectory, frames, time.perf_counter() - t0, dev)
    ids = sorted(out["trajectory"])
    out["ate"] = _sim3_ate(
        np.stack([-R.T @ t for R, t in (out["trajectory"][i] for i in ids)]),
        _centers([frames[i]["T_cw_gt"] for i in ids]))
    out["keyframes"] = fe.next_kf
    return out


def _phase_parity(cam, cfg, dev):
    """Phase 15: the port on the card against the port on the CPU, on the
    same CPU-rendered uint8 frames and the same RANSAC draws (`cam` and
    `cfg`: phase 8's). The CPU runs go one after another on a worker thread
    of this process while the card runs go on this one. Returns the
    single-image kernel launches of its card runs."""
    from concurrent.futures import ThreadPoolExecutor

    from scavislam_tpu_torch.io.synthetic import closed_box
    from scavislam_tpu_torch.ops import stereo_bm
    bm = stereo_bm.block_matching_disparity_bm
    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    cam_s, scfg = _loop_cam_cfg(cfg, 0.25, windows=(3, 8))
    spin_cfg = {m: dataclasses.replace(scfg, ui=dataclasses.replace(
        scfg.ui, stereo_method=m)) for m in (2, 1)}
    spin = parity_frames(cam_s, LOOP_FRAMES, kind="spin",
                         planes=closed_box(), step=1.0 / (LOOP_FRAMES - 1))
    wander = parity_frames(cam, PARITY_WANDER_FRAMES, kind="wander",
                           planes=closed_box(), step=0.06)
    arc = [{"frame_id": f["frame_id"], "left": f["left"],
            "T_cw_gt": f["T_cw_gt"]}
           for f in parity_frames(cam, PARITY_MONO_FRAMES, step=MONO_STEP)]
    render_s = time.perf_counter() - t_phase
    launches_before = bm.launches
    card_launches = 0

    def on_card(fn, rcam, rcfg, frames):
        """fn on the card, its kernel launches checked: one per frame in a
        stereo run at method 2, none otherwise."""
        nonlocal card_launches
        n0 = bm.launches
        r = fn(rcam, rcfg, dev, frames)
        n = bm.launches - n0
        want = (len(frames) if fn is parity_run
                and rcfg.ui.stereo_method == 2 else 0)
        if n != want:
            _fail(f"parity: {n} kernel launches in a card run, {want} "
                  "expected")
        card_launches += n
        return r

    with ThreadPoolExecutor(max_workers=1) as pool:
        host = {m: pool.submit(parity_run, cam_s, spin_cfg[m], cpu, spin)
                for m in (2, 1)}
        host["wander"] = pool.submit(parity_run, cam, cfg, cpu, wander)
        host["mono"] = pool.submit(parity_mono, cam, cfg, cpu, arc)
        card = {m: on_card(parity_run, cam_s, spin_cfg[m], spin)
                for m in (2, 1)}
        card["again"] = on_card(parity_run, cam_s, spin_cfg[2], spin)
        card["wander"] = on_card(parity_run, cam, cfg, wander)
        card["mono"] = on_card(parity_mono, cam, cfg, arc)
        host = {k: f.result() for k, f in host.items()}
    if bm.launches - launches_before != card_launches:
        _fail("parity: a CPU run launched the kernel")

    misses = []
    for m in (2, 1):
        cmp = parity_compare(card[m], host[m], SPIN_COUNTS)
        _parity_line(f"spin method {m} (card/CPU)", card[m], host[m], cmp,
                     SPIN_COUNTS, JAX_LINK[f"spin method {m}"])
        misses += [f"spin method {m}: {x}" for x in cmp["misses"]]
    det = parity_compare(card["again"], card[2], SPIN_COUNTS)
    _parity_line("spin method 2 (card/card, determinism)", card["again"],
                 card[2], det, SPIN_COUNTS)
    misses += [f"card determinism: {x}" for x in det["misses"]]
    cmp = parity_compare(card["wander"], host["wander"], WANDER_COUNTS)
    _parity_line(f"wander 512x384, {PARITY_WANDER_FRAMES} of phase 8's "
                 f"{N_FRAMES} frames (card/CPU)", card["wander"],
                 host["wander"], cmp, WANDER_COUNTS,
                 JAX_LINK["wander 512x384"])
    misses += [f"wander: {x}" for x in cmp["misses"]]
    mc, mh = card["mono"], host["mono"]
    mcmp = parity_compare(mc, mh, ("keyframes",))
    _parity_line(f"mono forward arc {PARITY_MONO_FRAMES} frames (card/CPU, "
                 "Sim3-aligned ATE; reported, gated on tracking only)", mc,
                 mh, mcmp, ("keyframes",))
    if mc["tracked"] != len(arc) or mh["tracked"] != len(arc):
        misses.append(f"mono: tracked {mc['tracked']} (card) and "
                      f"{mh['tracked']} (CPU) of {len(arc)}")
    print(f"parity: phase 15 took {time.perf_counter() - t_phase:.1f} s "
          f"({render_s:.1f} s rendering on the CPU; the CPU runs beside the "
          f"card's, so each wall time holds the other's load), kernel "
          f"launches {card_launches}", flush=True)
    if misses:
        _fail(f"parity: {misses}")
    return card_launches


STEP_STATE_FRAMES = 12  # phase 16 steps from the state after these frames
STEP_SYNC_FRAMES = 10


def _leaves(out):
    from torch.utils._pytree import tree_leaves
    return tree_leaves(out)


def _step_args(fe, frame):
    """The frontend_step arguments StereoFrontend._run_step passes for
    `frame` (the frontend steps it eagerly, then its pose chain is put
    back)."""
    from scavislam_tpu_torch.models.frontend_step import frontend_step
    rec = {}

    def record(*args, **kwargs):
        rec["args"], rec["kwargs"] = list(args), kwargs
        return frontend_step(*args, **kwargs)

    step, chain = fe._step, (fe._dev_R_cw, fe._dev_t_cw)
    fe._step = record
    try:
        fe._run_step(frame, fe._collect_candidates())
    finally:
        fe._step = step
        fe._dev_R_cw, fe._dev_t_cw = chain
    return rec["args"], rec["kwargs"]


# a lane of a batched step against the single-stream step on the same
# inputs (they round differently): the match counts, the matched set and
# the gates equal; the pose and the observations within the CPU tests'
# bars (tests/test_torch_multistream_vmap.py: R and t 1e-6, the packed
# vector 2e-4 plus 1e-6 relative; each mono leaf 1e-5), or, where the
# single-stream step itself moves further when its f32 state moves by one
# ulp, within LANE_WITNESS_MARGIN times that move (`_rounding_spread`, the
# CPU tests' `rounding_spread` on the card)
LANE_POSE_TOL, LANE_OBS_TOL, MONO_LANE_TOL = 1e-6, 2e-4, 1e-5
LANE_WITNESS_MARGIN = 2.0
LANE_WITNESS_DRAWS = 4
# phase 7 (b)'s draws: the single-stream step's move under one-ulp state
# moves is heavy-tailed (its LMs' accept decisions flip), so 4 draws often
# miss it. Measured on an H100 from the states of ticks 6, 10, 12, 16 and
# 20, for two versions of the step (the dense evaluation in PyTorch and as
# a CUDA kernel): with 4 draws some lane of 2 of the 5 ticks of each
# version left the bar (by up to 18x); with 16, 1 of 5 ticks of the
# first (by 1.4x) and none of the second
POOL_WITNESS_DRAWS = 16
# the f32 state of frontend_step's and mono_step's arguments: the dense
# state, the previous pose, the tables
STEREO_STATE, MONO_STATE = (1, 2, 4, 5, 6, 8, 9), (1, 2, 4, 5, 6)


def _one_ulp(x, gen):
    """`x` with each element moved by -1, 0 or +1 f32 ulp at random."""
    step = torch.randint(-1, 2, x.shape, generator=gen, device=x.device)
    up = torch.nextafter(x, torch.full_like(x, float("inf")))
    down = torch.nextafter(x, torch.full_like(x, float("-inf")))
    return torch.where(step > 0, up, torch.where(step < 0, down, x))


def _rounding_spread(single, args, state, leaves, draws=LANE_WITNESS_DRAWS):
    """The single-stream step's own sensitivity to rounding on a state: the
    largest move of each leaf of ``leaves(single(*args))`` over `draws`
    calls with every f32 tensor of ``args[i]``, i in `state`, moved by at
    most one ulp."""
    from torch.utils._pytree import tree_map
    gen = torch.Generator(device=args[0].device).manual_seed(0)
    base = leaves(single(*args))
    worst = dict.fromkeys(base, 0.0)
    for _ in range(draws):
        moved = list(args)
        for i in state:
            moved[i] = tree_map(
                lambda x: _one_ulp(x, gen) if isinstance(x, torch.Tensor)
                and x.dtype == torch.float32 else x, args[i])
        got = leaves(single(*moved))
        for k in base:
            worst[k] = max(worst[k], float(torch.abs(got[k] - base[k]).max()))
    return worst


def _stereo_leaves(out):
    """A stereo step's pose block (R, t, R_cak, t_cak) and observations."""
    C = out.gate.shape[-1]
    return {"pose": out.packed[:24], "obs": out.packed[34 + 2 * C:]}


def _lane_bars(spread):
    """The stereo lane bars on a state whose single-stream step moves
    `spread` under one-ulp state moves."""
    return {"pose": max(LANE_POSE_TOL, LANE_WITNESS_MARGIN * spread["pose"]),
            "obs": max(LANE_OBS_TOL, LANE_WITNESS_MARGIN * spread["obs"])}


def _lane_diff(out, s, ref, bars):
    """(|R diff|, |t diff|, packed max |diff|, within `bars`, gates equal)
    of lane `s` of a batched step against a step `ref`."""
    C = ref.gate.shape[0]
    p, q = out.packed[s], ref.packed
    d = torch.abs(p - q)
    ok = (float(d[:24].max()) <= bars["pose"]
          and torch.equal(p[24:26], q[24:26])
          and torch.equal(p[34:34 + 2 * C], q[34:34 + 2 * C])
          and bool((d[34 + 2 * C:]
                    <= bars["obs"] + 1e-6 * q[34 + 2 * C:].abs()).all()))
    return (float(torch.abs(out.R_cw[s] - ref.R_cw).max()),
            float(torch.abs(out.t_cw[s] - ref.t_cw).max()), float(d.max()),
            ok, bool(torch.equal(out.gate[s], ref.gate)))


def _lane_line(rows, bars=None):
    return ", ".join(
        f"[{r:.1e} {t:.1e} {p:.1e}{'' if ok else ' OVER'}"
        f"{'' if g else ' gates differ'}"
        + ("" if bars is None else
           f" bars {bars[i]['pose']:.1e} {bars[i]['obs']:.1e}") + "]"
        for i, (r, t, p, ok, g) in enumerate(rows))


def _pool_lanes(pool, args):
    """Phase 7 (b): from the state of phase 7's tick POOL_STATE_TICKS
    (`args`, the pool's step arguments), one replay of the pool's batched
    program held lane by lane against each stream's single-stream step
    from the same lane state, replayed by a StepGraph (stereo method 2 on
    the same frames: the batched kernel equals the single-image kernel per
    stream, phase 5). Returns the batched replay's output and {name: call}
    for the profile line."""
    from scavislam_tpu_torch.models.frontend_step import DENSE_SUBS_BATCHED
    from scavislam_tpu_torch.models.step_graph import StepGraph
    from scavislam_tpu_torch.parallel.multistream import stream_slice

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pool.step(*args)
    host_ms = 1e3 * (time.perf_counter() - t0)
    fe = pool.fes[0]
    frames, clouds, intens, valids, Js, R, t, ak, poses, points, cand = args
    singles = [(frames[s], *(stream_slice(x, s) for x in
                             (clouds, intens, valids, Js)),
                R[s], t[s], ak[s], stream_slice(poses, s),
                stream_slice(points, s), cand[s], fe._cam_params,
                fe._cam_statics, fe.levels, fe._num_disp, False,
                float(pool.cfg.ui.max_reproj_error), 2)
               for s in range(pool.B)]
    kw = {"dense_subs": DENSE_SUBS_BATCHED}
    graph = StepGraph()
    graph(*singles[0], **kw)  # the capture; its result is the warm-up's
    refs = [graph(*a, **kw) for a in singles]
    spreads = [_rounding_spread(lambda *x: graph(*x, **kw), a, STEREO_STATE,
                                _stereo_leaves, POOL_WITNESS_DRAWS)
               for a in singles]
    bars = [_lane_bars(sp) for sp in spreads]
    rows = [_lane_diff(out, s, refs[s], bars[s]) for s in range(pool.B)]
    spread_line = ", ".join(f"[{sp['pose']:.1e} {sp['obs']:.1e}]"
                            for sp in spreads)
    ms_b = _cuda_ms(lambda: pool.step(*args), 5)
    ms_1 = _cuda_ms(lambda: [graph(*a, **kw) for a in singles], 3)
    print(f"pool (b): tick {POOL_STATE_TICKS}'s state, one replay of the "
          f"B = {pool.B} program ({host_ms:.1f} host ms) against each "
          f"stream's single-stream StepGraph replay, per stream [|R diff| "
          f"|t diff| packed max, bars pose obs]: {_lane_line(rows, bars)} "
          f"(counts, matches and gates equal; pose within "
          f"{LANE_POSE_TOL:g} and observations within {LANE_OBS_TOL:g} px "
          f"plus 1e-6 relative, or {LANE_WITNESS_MARGIN:g} times the "
          f"single-stream replay's own move over {POOL_WITNESS_DRAWS} "
          f"one-ulp moves of its state where larger: per stream [pose obs] "
          f"{spread_line}); ms between CUDA events {ms_b:.2f} per batched replay against "
          f"{ms_1:.2f} for {pool.B} single-stream replays", flush=True)
    if not all(ok and g for _, _, _, ok, g in rows):
        _fail("pool (b): a lane of the batched program left its bar")
    return out, bars, {"pool tick program, B = 8": lambda: pool.step(*args)}


def _phase_step_graph(cam, cfg, dev, frames, seq):
    """Phase 16: the stereo frame step as a CUDA graph replay (StepGraph)
    against the eager step, at 512x384 with Config(). Returns
    {name: call} for the profile lines."""
    from scavislam_tpu_torch.models.frontend import StereoFrontend
    from scavislam_tpu_torch.models.frontend_step import frontend_step
    from scavislam_tpu_torch.models.step_graph import StepGraph
    from scavislam_tpu_torch.ops import stereo_bm
    bm = stereo_bm.block_matching_disparity_bm
    t_phase = time.perf_counter()

    # -- (a) one replay against the eager step from the same state
    fe = StereoFrontend(cam, cfg, device=dev)
    fe.process_first_frame(frames[0])
    for f in frames[1:STEP_STATE_FRAMES]:
        if not fe.process_frame(f)[0]:
            _fail(f"step graph: tracking failed at frame {f['frame_id']}")
    if fe.next_kf < 2:
        _fail("step graph: fewer than 2 keyframes in the starting state")
    nxt = frames[STEP_STATE_FRAMES]
    args, kwargs = _step_args(fe, nxt)
    ext = args.copy()
    gt = seq.frame(STEP_STATE_FRAMES)["disp_gt"]
    ext[0] = torch.stack([nxt["left"].float(), nxt["right"].float(), gt])
    ext[15] = True
    variants = {"method 2": args, "external disparity": ext}
    for m in (3, 4):
        variants[f"method {m}"] = args[:17] + [m] + args[18:]
    results, calls = [], {}
    for name, a in variants.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager = frontend_step(*a, **kwargs)
        host_eager = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        graph = StepGraph()
        graph(*a, **kwargs)  # the capture; its result is the warm-up's
        torch.cuda.synchronize()
        n0 = bm.launches
        t0 = time.perf_counter()
        replayed = graph(*a, **kwargs)
        host_replay = 1e3 * (time.perf_counter() - t0)
        moved = bm.launches - n0
        torch.cuda.synchronize()
        differ = [field for field, x, y in zip(eager._fields, replayed, eager)
                  if not all(torch.equal(p, q) for p, q
                             in zip(_leaves(x), _leaves(y)))]
        want = 1 if name == "method 2" else 0
        results.append((name, differ, moved, want))
        line = (f"step graph (a) {name}: replay torch.equal to the eager "
                f"step {not differ}" + (f" (differ: {differ})" if differ
                                        else "")
                + f", block-matching launches per replay {moved} (want "
                f"{want}), tracked {int(eager.packed[25])} gated; host ms "
                f"eager {host_eager:.1f} replay {host_replay:.2f}")
        if name in ("method 2", "method 3"):
            ms_e = _cuda_ms(lambda a=a: frontend_step(*a, **kwargs), 5)
            ms_r = _cuda_ms(lambda a=a, g=graph: g(*a, **kwargs),
                            TIMING_RUNS)
            line += (f"; ms between CUDA events eager {ms_e:.2f} replay "
                     f"{ms_r:.3f} (median of 5 / {TIMING_RUNS})")
            calls[f"eager step, {name}"] = (
                lambda a=a: frontend_step(*a, **kwargs))
            calls[f"replay, {name}"] = lambda a=a, g=graph: g(*a, **kwargs)
        print(line, flush=True)

    # -- (b) synchronizing calls per frame through process_frame
    counts, wall, kf = {}, {}, {}
    for mode in ("graph", "eager"):
        fe = StereoFrontend(cam, cfg, device=dev)
        if mode == "eager":
            fe._step = frontend_step
        n0 = bm.launches
        fe.process_first_frame(frames[0])
        counts[mode], wall[mode], kf[mode] = [], [], []
        for f in frames[1:1 + STEP_SYNC_FRAMES]:
            t0 = time.perf_counter()
            (ok, dropped), n = _counted_syncs(lambda f=f: fe.process_frame(f))
            wall[mode].append(1e3 * (time.perf_counter() - t0))
            if not ok:
                _fail(f"step graph (b): {mode} lost frame {f['frame_id']}")
            counts[mode].append(n)
            kf[mode].append(dropped)
        launches = bm.launches - n0
        if mode == "graph" and launches != 1 + STEP_SYNC_FRAMES:
            _fail(f"step graph (b): {launches} block-matching launches for "
                  f"{1 + STEP_SYNC_FRAMES} frames")
    print(f"step graph (b): synchronizing calls per process_frame over "
          f"frames 1..{STEP_SYNC_FRAMES}: graph {counts['graph']}, eager "
          f"{counts['eager']} (keyframe spawned: {kf['graph']}); wall ms per "
          f"frame (median) graph {np.median(wall['graph']):.1f} eager "
          f"{np.median(wall['eager']):.1f}; block-matching launches one per "
          f"frame stepped; phase 16 took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    for name, differ, moved, want in results:
        if differ:
            _fail(f"step graph (a) {name}: the replay differs from the eager "
                  f"step in {differ}")
        if moved != want:
            _fail(f"step graph (a) {name}: {moved} block-matching launches "
                  f"per replay, {want} expected")
    if any(n != 1 for n, d in zip(counts["graph"], kf["graph"]) if not d):
        _fail(f"step graph (b): synchronizing calls per frame "
              f"{counts['graph']}, one expected on frames without a spawn")
    return calls


def _phase_dense_ic(dev, per_step, per_tick):
    """Phase 17; returns the kernel's entry of the `kernels` line (its
    numbers at nc's level 0 and the identity)."""
    from probes import dense_ic_cases as cases
    from scavislam_tpu_torch.ops import dense_ic
    t17 = time.perf_counter()
    rows, worst, nc0 = [], 0.0, None
    for cell, (streams, subs) in cases.CELLS.items():
        levels = cases.cell_levels(dev, streams, subs)
        for lv in (2, 1, 0):
            for k, (R, t) in enumerate(cases.poses(dev, streams)):
                o = cases.level_line(levels[lv], R, t, _cuda_ms)
                worst = max(worst, *o["vs_f64"])
                rows.append(f"{cell} L{lv} {o['B']}x{o['n']} "
                            f"{('identity', 'nearby')[k]}: "
                            f"{o['us_graph_kernel']:.2f} us (plain "
                            f"{o['us_graph_plain']:.1f}, bound "
                            f"{o['bound_us']:.2f}), vs plain "
                            f"{max(o['vs_plain']):.1e}, vs f64 "
                            f"{max(o['vs_f64']):.1e}")
                if (cell, lv, k) == ("nc", 0, 0):
                    nc0 = o
                if not (o["graph_equal"] and o.get("vmap_equal", True)):
                    _fail(f"dense_ic {cell} level {lv} pose {k}: replays "
                          "or lanes differ")
    print(f"dense_ic: us a call in a graph of {cases.GRAPH_CALLS}, at the "
          "identity and at a nearby pose; " + "; ".join(rows)
          + f"; largest difference from the float64 sum of the plain "
          f"version's terms {worst:.2e} (bar 2e-7); launches per step "
          f"replay {per_step:g}, per tick replay {per_tick:g} (want 93); "
          f"phase 17 took {time.perf_counter() - t17:.1f} s", flush=True)
    if worst > 2e-7:
        _fail(f"dense_ic against the float64 sum: {worst}")
    if (per_step, per_tick) != (93, 93):
        _fail(f"dense_ic launches per replay {per_step}, {per_tick} != 93")
    return {"name": "dense_ic", "route": "cuda",
            "source": "scavislam_tpu_torch/csrc/dense_ic.cu",
            "replaces": None, "launches": dense_ic.ic_pass.launches,
            "max_abs_err": nc0["vs_plain_abs"],
            "ms": nc0["us_graph_kernel"] / 1e3,
            "plain_ms": nc0["us_graph_plain"] / 1e3,
            "bound_ms": nc0["bound_us"] / 1e3, "bound_by": "bytes",
            "library_ms": None}


def _scenes(n):
    from scavislam_tpu_torch.io.synthetic import closed_box, varied_box
    return [closed_box()] + [varied_box(s) for s in range(1, n)]


def main():
    t_script = time.perf_counter()
    # -- 1. device
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this check needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card_line = smi[0].strip()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"device: {kind} x{count}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    from scavislam_tpu_torch.core.camera import StereoCamera
    from scavislam_tpu_torch.io.synthetic import SyntheticSequence, closed_box
    from scavislam_tpu_torch.models.frontend import StereoFrontend
    from scavislam_tpu_torch.ops import stereo_bm
    from scavislam_tpu_torch.ops.image import binomial3
    from scavislam_tpu_torch.ops.stereo import _sobel_x_prefilter
    from scavislam_tpu_torch.utils.config import Config

    cfg = Config()
    num_disp = 16 * cfg.ui.num_disp16

    # -- 2. kernel build
    lib = stereo_bm._Kernel.load(num_disp)
    print(f"build: stereo_bm D={num_disp} built+loaded in "
          f"{stereo_bm._Kernel.build_seconds[num_disp]:.2f} s", flush=True)
    ptx = _ptxas(stereo_bm._Kernel.logs[num_disp])
    dyn = {"bm_cost_kernel": lib.stereo_bm_smem_bytes()}
    ptx_line = "; ".join(
        f"{k} {r} registers, {sm} B static + {dyn.get(k, 0)} B dynamic "
        f"smem, {sp} B spilled" for k, (r, sm, sp) in sorted(ptx.items()))
    print(f"build: ptxas {ptx_line}", flush=True)
    if sorted(ptx) != ["bm_cost_kernel", "bm_lr_kernel"]:
        _fail(f"ptxas report names {sorted(ptx)}")
    if any(sp for _, _, sp in ptx.values()):
        _fail("a kernel spills registers")
    from scavislam_tpu_torch.ops import dense_ic
    dense_ic._Kernel.load()
    ptx_ic = _ptxas(dense_ic._Kernel.log)
    print(f"build: dense_ic built+loaded in "
          f"{dense_ic._Kernel.build_seconds:.2f} s; ptxas " + "; ".join(
              f"{k} {r} registers, {sm} B static smem, {sp} B spilled"
              for k, (r, sm, sp) in sorted(ptx_ic.items())), flush=True)
    if sorted(ptx_ic) != ["dense_ic_final_kernel", "dense_ic_partial_kernel"]:
        _fail(f"ptxas report names {sorted(ptx_ic)}")
    if any(sp for _, _, sp in ptx_ic.values()):
        _fail("a dense_ic kernel spills registers")

    cam = StereoCamera.create(cfg.cam.f, (cfg.cam.px, cfg.cam.py),
                              (cfg.cam.width, cfg.cam.height), cfg.cam.baseline)
    seq = SyntheticSequence(cam, n_frames=N_FRAMES, kind="wander",
                            planes=closed_box(), step=0.06, device=dev)

    # -- 3. kernel against its plain version, at the main path's shapes
    f0 = seq.frame(0)
    lf = _sobel_x_prefilter(binomial3(f0["left"]))
    rf = _sobel_x_prefilter(binomial3(f0["right"]))
    d_k = stereo_bm.bm_cuda(lf, rf, num_disp, 5)
    d_p = stereo_bm.bm_plain(lf, rf, num_disp, 5)
    torch.cuda.synchronize()
    vk = d_k > 0
    equal = torch.equal(d_k, d_p)
    max_abs_err = float(torch.abs(d_k - d_p).max())
    gt = f0["disp_gt"]
    m = vk & (gt > 1) & (gt < num_disp - 1)
    gt_med = float(torch.median(torch.abs(d_k[m] - gt[m])))
    ms_k = _cuda_ms(lambda: stereo_bm.bm_cuda(lf, rf, num_disp, 5), TIMING_RUNS)
    ms_p = _cuda_ms(lambda: stereo_bm.bm_plain(lf, rf, num_disp, 5), TIMING_RUNS)
    bound, bound_by = _bound_ms(1, *lf.shape, num_disp)
    print(f"kernel: {tuple(lf.shape)} D={num_disp} equal to plain {equal}, "
          f"max_abs_err {max_abs_err:.3g}, valid {float(vk.float().mean()):.4f}, "
          f"median |d-gt| {gt_med:.4f} px; ms kernel {ms_k:.4f} plain "
          f"{ms_p:.4f}; bound {1e3 * bound:.2f} us ({bound_by}), kernel at "
          f"{100 * bound / ms_k:.2f}% of it; ptxas {ptx_line}", flush=True)
    if not equal:
        _fail("kernel disagrees with its plain version")
    if not gt_med < 0.5:
        _fail(f"kernel median error against ground truth {gt_med} px")

    # -- 4. the slice: StereoFrontend on the wander, Config() defaults
    frames = []
    for i in range(N_FRAMES):
        f = seq.frame(i)
        frames.append({"frame_id": i, "left": f["left"], "right": f["right"],
                       "T_cw_gt": f["T_cw_gt"]})
    torch.cuda.synchronize()
    warm = StereoFrontend(cam, cfg, device=dev)  # cuBLAS/cuSOLVER init
    warm.process_first_frame(frames[0])
    warm.process_frame(frames[1])
    torch.cuda.synchronize()

    stereo_bm.block_matching_disparity_bm.launches = 0
    ic0 = dense_ic.ic_pass.launches
    fe = StereoFrontend(cam, cfg, device=dev)
    t0 = time.perf_counter()
    fe.process_first_frame(frames[0])
    est = [fe._world_pose()]
    stepped = tracked = 1
    t1 = time.perf_counter()
    for f in frames[1:]:
        stepped += 1
        ok, _ = fe.process_frame(f)
        if not ok:
            break
        tracked += 1
        est.append(fe._world_pose())
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = stereo_bm.block_matching_disparity_bm.launches
    # one step a frame: the capture's eager warm-up at frame 0, a replay
    # at each later frame
    ic_per_step = (dense_ic.ic_pass.launches - ic0) / stepped
    ate = _ate(est, [f["T_cw_gt"] for f in frames[:tracked]])
    fps = (tracked - 1) / (t2 - t1)
    print(f"slice: {tracked}/{N_FRAMES} frames tracked, {fe.next_kf} keyframes, "
          f"ATE {ate:.5f} m, {fps:.2f} frames/s over frames 1..{tracked - 1} "
          f"(first frame {1000 * (t1 - t0):.1f} ms), kernel launches {launches} "
          f"for {stepped} frames stepped", flush=True)
    if tracked != N_FRAMES:
        _fail(f"tracking failed at frame {tracked}")
    if fe.next_kf < 2:
        _fail("fewer than 2 keyframes")
    if launches != stepped:
        _fail(f"kernel launches {launches} != frames stepped {stepped}")
    if not ate < ATE_MAX:
        _fail(f"ATE {ate} m")

    # -- 5. the batched kernel against its plain version and the
    # single-image kernel, at the pool's shapes
    ms_seqs = [SyntheticSequence(cam, n_frames=N_TICKS, kind="wander",
                                 planes=p, step=0.06, device=dev)
               for p in _scenes(N_STREAMS)]
    f0s = [q.frame(0) for q in ms_seqs]
    lfb = torch.stack([_sobel_x_prefilter(binomial3(f["left"])) for f in f0s])
    rfb = torch.stack([_sobel_x_prefilter(binomial3(f["right"])) for f in f0s])
    db_k = stereo_bm.bm_cuda_batched(lfb, rfb, num_disp, 5)
    db_p = stereo_bm.bm_plain_batched(lfb, rfb, num_disp, 5)
    db_1 = torch.stack([stereo_bm.bm_cuda(lfb[b], rfb[b], num_disp, 5)
                        for b in range(N_STREAMS)])
    torch.cuda.synchronize()
    eq_plain = torch.equal(db_k, db_p)
    eq_single = torch.equal(db_k, db_1)
    max_abs_err_b = float(torch.abs(db_k - db_p).max())
    ms_kb = _cuda_ms(lambda: stereo_bm.bm_cuda_batched(lfb, rfb, num_disp, 5),
                     TIMING_RUNS)
    ms_pb = _cuda_ms(lambda: stereo_bm.bm_plain_batched(lfb, rfb, num_disp, 5),
                     TIMING_RUNS)
    ms_k1 = _cuda_ms(lambda: [stereo_bm.bm_cuda(lfb[b], rfb[b], num_disp, 5)
                              for b in range(N_STREAMS)], TIMING_RUNS)
    valid_b = [round(float((db_k[b] > 0).float().mean()), 4)
               for b in range(N_STREAMS)]
    bound_b, bound_by_b = _bound_ms(*lfb.shape, num_disp)
    print(f"batched: {tuple(lfb.shape)} D={num_disp} equal to plain "
          f"{eq_plain}, equal to single-image kernel per stream {eq_single}, "
          f"max_abs_err {max_abs_err_b:.3g}, valid per stream {valid_b}; "
          f"ms batched kernel {ms_kb:.4f} plain batched {ms_pb:.4f} "
          f"{N_STREAMS} single-image launches {ms_k1:.4f}; bound "
          f"{1e3 * bound_b:.2f} us ({bound_by_b}), batched kernel at "
          f"{100 * bound_b / ms_kb:.2f}% of it; ptxas {ptx_line}", flush=True)
    if not (eq_plain and eq_single):
        _fail("batched kernel disagrees with its plain version or with the "
              "single-image kernel")
    if min(valid_b) < 0.3:
        _fail(f"batched kernel valid fractions {valid_b}")

    # -- 6. the pipelined single-stream path on phase 4's frames
    stereo_bm.block_matching_disparity_bm.launches = 0
    stereo_bm.block_matching_disparity_bm_batched.launches = 0
    fe = StereoFrontend(cam, cfg, device=dev)
    fe.pipeline_depth = 2
    fe.timing_log = []
    t0 = time.perf_counter()
    fe.process_first_frame(frames[0])
    poses = {0: fe._world_pose()}
    t1 = time.perf_counter()
    failed = None
    for f in frames[1:]:
        r = fe.process_frame_pipelined(f)
        if r is not None:
            ok, _, fid = r
            if not ok:
                failed = fid
                break
            poses[fid] = fe._world_pose()
    if failed is None:
        for ok, _, fid, pose, _ in fe.flush_pipeline():
            if not ok:
                failed = fid
                break
            if fid is not None:
                poses[fid] = pose
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches_p = stereo_bm.block_matching_disparity_bm.launches
    tracked_p = len(poses)
    fps_p = (N_FRAMES - 1) / (t2 - t1)
    ate_p = _ate([poses[i] for i in sorted(poses)],
                 [frames[i]["T_cw_gt"] for i in sorted(poses)])
    split = np.asarray([x[1:4] for x in fe.timing_log]) * 1000.0
    print(f"pipelined: {tracked_p}/{N_FRAMES} frames tracked, {fe.next_kf} "
          f"keyframes, ATE {ate_p:.5f} m, {fps_p:.2f} frames/s over frames "
          f"1..{N_FRAMES - 1} (synchronous phase 4: {fps:.2f}); per frame ms "
          f"dispatch {split[:, 0].mean():.2f} fetch wait {split[:, 1].mean():.3f} "
          f"consume {split[:, 2].mean():.2f}; kernel launches {launches_p} "
          f"for {N_FRAMES} frames stepped", flush=True)
    if failed is not None or tracked_p != N_FRAMES:
        _fail(f"pipelined tracking failed at frame {failed}")
    if fe.next_kf < 2:
        _fail("pipelined: fewer than 2 keyframes")
    if launches_p != N_FRAMES:
        _fail(f"pipelined: kernel launches {launches_p} != {N_FRAMES}")
    if not ate_p < ATE_MAX:
        _fail(f"pipelined ATE {ate_p} m")

    # -- 7. the pool: 8 streams through one batched step per tick
    from scavislam_tpu_torch.parallel.stream_pool import StreamPool

    ticks = [[{"frame_id": i, "left": f["left"], "right": f["right"]}
              for f in (q.frame(i) for q in ms_seqs)] for i in range(N_TICKS)]
    gts = [[q.poses[i] for i in range(N_TICKS)] for q in ms_seqs]
    torch.cuda.synchronize()
    stereo_bm.block_matching_disparity_bm.launches = 0
    stereo_bm.block_matching_disparity_bm_batched.launches = 0
    pool = StreamPool(cam, cfg, n_streams=N_STREAMS, mesh=None,
                      pipeline_depth=2, device=dev)
    pool.timing_log = []
    step = pool.step
    (graph,) = step.graphs
    state = {}

    def record(*args):  # keeps (b)'s starting state
        if len(pool.timing_log) == POOL_STATE_TICKS - 1:
            state["args"] = args
        return step(*args)

    pool.step = record
    ic0 = dense_ic.ic_pass.launches
    t0 = time.perf_counter()
    pool.process_first_frames(ticks[0])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    syncs, spawned, decided = [], [], []
    for tick in ticks[1:]:
        kf0 = pool.keyframe_counts()
        res, n_sync = _syncs_in(lambda tick=tick: pool.process_frames(tick))
        syncs.append(n_sync)
        decided.append(sum(b - a for a, b in zip(kf0,
                                                 pool.keyframe_counts())))
        spawned.append(kf0 != pool.keyframe_counts()
                       or any(landed for _, landed, _ in res or ()))
    pool.finish()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    pool.step = step
    launches_b = stereo_bm.block_matching_disparity_bm_batched.launches
    launches_1 = stereo_bm.block_matching_disparity_bm.launches
    ic_per_tick = (dense_ic.ic_pass.launches - ic0) / N_TICKS
    captures, replays = graph.captures, graph.replays
    fps_pool = N_STREAMS * (N_TICKS - 1) / (t2 - t1)
    ms_tick = 1000.0 * (t2 - t1) / (N_TICKS - 1)
    kfs = pool.keyframe_counts()
    ates = []
    for s in range(N_STREAMS):
        traj = pool.trajectories[s]
        ates.append(_ate([T for _, T in traj], [gts[s][i] for i, _ in traj])
                    if traj else float("inf"))
    lens = [len(t) for t in pool.trajectories]
    split = np.asarray([x[:3] for x in pool.timing_log]) * 1000.0
    print(f"pool: {N_STREAMS} streams x {N_TICKS} ticks, alive {pool.alive}, "
          f"trajectory entries {lens}, keyframes {kfs}, ATE per stream "
          f"{[round(a, 5) for a in ates]} m; {fps_pool:.2f} frames/s "
          f"aggregate, {ms_tick:.1f} ms per tick over ticks 1..{N_TICKS - 1} "
          f"(first tick {1000 * (t1 - t0):.1f} ms); per tick ms dispatch "
          f"{split[:, 0].mean():.2f} fetch wait {split[:, 1].mean():.3f} "
          f"consume {split[:, 2].mean():.2f}; the tick's program: "
          f"{captures} CUDA graph capture (tick 0), {replays} replays for "
          f"ticks 1..{N_TICKS - 1}; batched kernel launches {launches_b} "
          f"for {N_TICKS} ticks dispatched, single-image launches "
          f"{launches_1}; synchronizing calls per tick {syncs} (sync debug "
          f"mode; the one wait per tick, on the packed fetch's CUDA event, "
          f"is not among them; a keyframe decided or landed: "
          f"{[int(x) for x in spawned]}; keyframes decided {decided}, at "
          f"most {SPAWN_SYNCS} synchronizing calls each)", flush=True)
    if not all(pool.alive) or lens != [N_TICKS] * N_STREAMS:
        _fail("pool: a stream lost tracking")
    if min(kfs) < 2:
        _fail(f"pool: keyframes per stream {kfs}")
    if not max(ates) < ATE_MAX:
        _fail(f"pool: ATE per stream {ates}")
    if launches_b != N_TICKS or launches_1 != 0:
        _fail(f"pool: batched launches {launches_b} != {N_TICKS} ticks or "
              f"single-image launches {launches_1} != 0")
    if (captures, replays) != (1, N_TICKS - 1):
        _fail(f"pool: {captures} captures and {replays} replays for "
              f"{N_TICKS} ticks, one capture and a replay per later tick "
              "expected")
    if any(n > SPAWN_SYNCS * d for n, d in zip(syncs, decided)):
        _fail(f"pool: synchronizing calls per tick {syncs}, at most "
              f"{SPAWN_SYNCS} per keyframe decided {decided} expected")
    pool_ref = {"traj": [list(t) for t in pool.trajectories], "ates": ates,
                "kfs": kfs, "args": state["args"]}
    pool_ref["lanes"], pool_ref["bars"], pool_call = _pool_lanes(
        pool, state["args"])

    # -- 8. the system: frontend + backend, bench.py's headline configuration
    stereo_bm.block_matching_disparity_bm.launches = 0
    _run_system(cam, cfg, dev, frames[:12], threaded=True, pipelined=True)
    torch.cuda.synchronize()
    stereo_bm.block_matching_disparity_bm.launches = 0
    stereo_bm.block_matching_disparity_bm_batched.launches = 0
    sys_t = _run_system(cam, cfg, dev, frames, threaded=True, pipelined=True)
    launches_s = stereo_bm.block_matching_disparity_bm.launches
    _check_system("system threaded pipelined", sys_t, launches_s,
                  stereo_bm.block_matching_disparity_bm_batched.launches)
    # the same with loop closure on, as users run it
    _run_system(cam, cfg, dev, frames[:12], threaded=True, pipelined=True,
                loop_closure=True)
    torch.cuda.synchronize()
    stereo_bm.block_matching_disparity_bm.launches = 0
    stereo_bm.block_matching_disparity_bm_batched.launches = 0
    sys_l = _run_system(cam, cfg, dev, frames, threaded=True, pipelined=True,
                        loop_closure=True)
    _check_system("system loop closure", sys_l,
                  stereo_bm.block_matching_disparity_bm.launches,
                  stereo_bm.block_matching_disparity_bm_batched.launches)
    pr = sys_l["system"].place_recognizer
    print(f"system loop closure: {sys_l['fps']:.2f} frames/s with loop "
          f"closure on against {sys_t['fps']:.2f} off in this call; "
          f"recognizer counters {dict(sorted(pr.counters.items()))}, "
          f"{len(pr.location_map)} places for {sys_l['keyframes']} "
          f"keyframes, closed loops {len(sys_l['system'].closed_loops)}",
          flush=True)
    if pr.counters["indexed"] != sys_l["keyframes"]:
        _fail(f"system loop closure: indexed {pr.counters['indexed']} != "
              f"keyframes {sys_l['keyframes']}")
    if pr.counters["described"] != 0:
        _fail("system loop closure: the recognizer described "
              f"{pr.counters['described']} keyframes itself")
    stereo_bm.block_matching_disparity_bm.launches = 0
    sys_u = _run_system(cam, cfg, dev, frames, threaded=False,
                        pipelined=False)
    _check_system("system unthreaded sync", sys_u,
                  stereo_bm.block_matching_disparity_bm.launches, 0)
    _time_solve(sys_t["system"].backend.graph)
    _phase_loop(cfg, dev)
    _phase_relocalize(cfg, dev)
    with tempfile.TemporaryDirectory() as tmp:
        n_disk, nc_cfg, fps_a = _phase_disk(cam, cfg, dev, seq, frames,
                                            sys_l["fps"], tmp)
        launches += n_disk
        bl, br = _phase_stereo_methods(f0, num_disp, ms_k, nc_cfg, fps_a,
                                       frames, tmp)
        stereo_bm.block_matching_disparity_bm.launches = 0
        stereo_bm.block_matching_disparity_bm_batched.launches = 0
        n_mono, mono_call = _phase_mono(cam, cfg, dev, tmp)
        if n_mono != 0:
            _fail(f"mono: {n_mono} block-matching launches")
        launches += n_mono
        launches_b += n_mono
        # -- 14. the viewers, the vocabulary trainer and the mesh
        t14 = time.perf_counter()
        _phase_viewers(cam, cfg, dev, frames, num_disp)
        launches += _phase_viewer_cli(nc_cfg, frames, fps_a, tmp)
        _phase_dictionary(dev, os.path.dirname(nc_cfg))
        launches_b += _phase_mesh(cam, cfg, dev, frames,
                                  sys_t["system"].backend.graph, sys_u,
                                  ticks, gts, pool_ref)
        print(f"phase 14 took {time.perf_counter() - t14:.1f} s", flush=True)
    # -- 15. the card against the CPU on the same frames and draws
    launches += _phase_parity(cam, cfg, dev)
    # -- 16. the frame step as a CUDA graph against the eager step
    step_calls = _phase_step_graph(cam, cfg, dev, frames, seq)
    # -- 17. the dense tracker's evaluation at the cells' shapes
    ic_record = _phase_dense_ic(dev, ic_per_step, ic_per_tick)

    try:
        dev_us = {k[:60]: round(us, 2) for k, _, us in _kernel_profile(
            lambda: stereo_bm.bm_cuda(lf, rf, num_disp, 5), TIMING_RUNS)}
    except Exception as e:  # the profiler is a report, not a check
        dev_us = f"not measured ({type(e).__name__}: {e})"
    print(f"profile: device us per single-image call {dev_us}", flush=True)
    for name, fn in _bp_calls(num_disp).items():
        try:
            rows = _kernel_profile(lambda: fn(bl, br), 5)
            prof = (f"{sum(n for _, n, _ in rows):.0f} CUDA kernel launches "
                    f"per call, {sum(us for _, _, us in rows) / 1e3:.3f} ms "
                    "of kernel time summed (5 calls)")
        except Exception as e:  # the profiler is a report, not a check
            prof = f"not measured ({type(e).__name__}: {e})"
        print(f"profile: {name} at 512x384 D={num_disp}: {prof}", flush=True)
    try:
        rows = _kernel_profile(mono_call, 5)
        prof = (f"{sum(n for _, n, _ in rows):.0f} CUDA kernel launches "
                f"per call, {sum(us for _, _, us in rows) / 1e3:.3f} ms of "
                "kernel time summed (5 calls)")
    except Exception as e:  # the profiler is a report, not a check
        prof = f"not measured ({type(e).__name__}: {e})"
    print(f"profile: mono_step at 512x384 (phase 13 a): {prof}", flush=True)
    kernels = {}
    for name, fn in {**step_calls, **pool_call}.items():
        try:
            rows = _kernel_profile(fn, 3)
            kernels[name] = sum(n for _, n, _ in rows)
            prof = (f"{kernels[name]:.0f} CUDA kernel launches per call, "
                    f"{sum(us for _, _, us in rows) / 1e3:.3f} ms of kernel "
                    "time summed (3 calls)")
        except Exception as e:  # the profiler is a report, not a check
            prof = f"not measured ({type(e).__name__}: {e})"
        where = ("frame step at 512x384 (phase 16)" if name in step_calls
                 else f"tick at 512x384 (phase 7 b; one stream's replay in "
                 f"phase 16: {kernels.get('replay, method 2', 'not measured')}"
                 " kernels)")
        print(f"profile: {where}, {name}: {prof}", flush=True)

    print(json.dumps({"kernels": [
        {"name": "stereo_bm", "route": "cuda", "source": ROUTE_SOURCE,
         "replaces": REPLACES, "launches": launches,
         "max_abs_err": max_abs_err, "ms": ms_k, "plain_ms": ms_p,
         "bound_ms": bound, "bound_by": bound_by, "library_ms": None},
        {"name": "stereo_bm_batched", "route": "cuda", "source": ROUTE_SOURCE,
         "replaces": REPLACES_BATCHED, "launches": launches_b,
         "max_abs_err": max_abs_err_b, "ms": ms_kb, "plain_ms": ms_pb,
         "bound_ms": bound_b, "bound_by": bound_by_b, "library_ms": None},
        ic_record,
    ]}))
    print(f"script: {time.perf_counter() - t_script:.1f} s from start to "
          "the result line", flush=True)
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()

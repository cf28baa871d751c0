"""Drive the PyTorch port's stereo-VO paths once on one CUDA card: the
synchronous and pipelined single-stream frontend and the 8-stream pool.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each prints its numbers on its own line; any failure exits
non-zero before the result line):

1. device  — a CUDA card must be present (there is no CPU fallback); the
   card's name and power limit as nvidia-smi reports them;
2. build   — the block-matching kernels (bm_cost_kernel, bm_lr_kernel)
   are compiled from the checkout's sources
   (scavislam_tpu_torch/csrc/stereo_bm.cu -> build/kernels/); ptxas's
   registers, shared memory and spills of both (a spill fails);
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
   ATE < 0.05 m;
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
   on its phase-5 scene along the wander at step 0.06, 512x384, 40 ticks:
   aggregate frames/s, ms per tick and its split, keyframes per stream;
   every stream alive with 40 trajectory entries, >= 2 keyframes and
   ATE < 0.05 m each; one batched launch per tick dispatched and no
   single-image launch.

After the phases, the device time of each kernel of one single-image call
(torch.profiler; last, so that its tracing cannot slow the timed phases).
The last three lines are the per-kernel JSON record, the card's name and
power limit, and the result line.
"""

import json
import re
import subprocess
import sys
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
N_TICKS = 40
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
            name = next((k for k in ("bm_cost_kernel", "bm_lr_kernel")
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


def _kernel_device_us(fn, runs):
    """{device kernel name: mean microseconds per call} over `runs` calls
    of fn, from torch.profiler's CUDA activity."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: round(e.device_time_total / runs, 2)
            for e in prof.key_averages() if e.device_time_total}


def _ate(est, gt):
    errs = []
    for Te, Tg in zip(est, gt):
        Rg = Tg.R.numpy().astype(np.float64)
        tg = Tg.t.numpy().astype(np.float64)
        errs.append(Te.R @ (-Rg.T @ tg) + Te.t)  # translation of Te @ Tg^-1
    errs = np.stack(errs)
    return float(np.sqrt((errs ** 2).sum(axis=1).mean()))


def _scenes(n):
    from scavislam_tpu_torch.io.synthetic import closed_box, varied_box
    return [closed_box()] + [varied_box(s) for s in range(1, n)]


def main():
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
    split = np.asarray([x[1:] for x in fe.timing_log]) * 1000.0
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
    t0 = time.perf_counter()
    pool.process_first_frames(ticks[0])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for tick in ticks[1:]:
        pool.process_frames(tick)
    pool.finish()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches_b = stereo_bm.block_matching_disparity_bm_batched.launches
    launches_1 = stereo_bm.block_matching_disparity_bm.launches
    fps_pool = N_STREAMS * (N_TICKS - 1) / (t2 - t1)
    ms_tick = 1000.0 * (t2 - t1) / (N_TICKS - 1)
    kfs = pool.keyframe_counts()
    ates = []
    for s in range(N_STREAMS):
        traj = pool.trajectories[s]
        ates.append(_ate([T for _, T in traj], [gts[s][i] for i, _ in traj])
                    if traj else float("inf"))
    lens = [len(t) for t in pool.trajectories]
    split = np.asarray(pool.timing_log) * 1000.0
    print(f"pool: {N_STREAMS} streams x {N_TICKS} ticks, alive {pool.alive}, "
          f"trajectory entries {lens}, keyframes {kfs}, ATE per stream "
          f"{[round(a, 5) for a in ates]} m; {fps_pool:.2f} frames/s "
          f"aggregate, {ms_tick:.1f} ms per tick over ticks 1..{N_TICKS - 1} "
          f"(first tick {1000 * (t1 - t0):.1f} ms); per tick ms dispatch "
          f"{split[:, 0].mean():.2f} fetch wait {split[:, 1].mean():.3f} "
          f"consume {split[:, 2].mean():.2f}; batched kernel launches "
          f"{launches_b} for {N_TICKS} ticks dispatched, single-image "
          f"launches {launches_1}", flush=True)
    if not all(pool.alive) or lens != [N_TICKS] * N_STREAMS:
        _fail("pool: a stream lost tracking")
    if min(kfs) < 2:
        _fail(f"pool: keyframes per stream {kfs}")
    if not max(ates) < ATE_MAX:
        _fail(f"pool: ATE per stream {ates}")
    if launches_b != N_TICKS or launches_1 != 0:
        _fail(f"pool: batched launches {launches_b} != {N_TICKS} ticks or "
              f"single-image launches {launches_1} != 0")

    try:
        dev_us = _kernel_device_us(
            lambda: stereo_bm.bm_cuda(lf, rf, num_disp, 5), TIMING_RUNS)
    except Exception as e:  # the profiler is a report, not a check
        dev_us = f"not measured ({type(e).__name__}: {e})"
    print(f"profile: device us per single-image call {dev_us}", flush=True)

    print(json.dumps({"kernels": [
        {"name": "stereo_bm", "route": "cuda", "source": ROUTE_SOURCE,
         "replaces": REPLACES, "launches": launches,
         "max_abs_err": max_abs_err, "ms": ms_k, "plain_ms": ms_p,
         "bound_ms": bound, "bound_by": bound_by, "library_ms": None},
        {"name": "stereo_bm_batched", "route": "cuda", "source": ROUTE_SOURCE,
         "replaces": REPLACES_BATCHED, "launches": launches_b,
         "max_abs_err": max_abs_err_b, "ms": ms_kb, "plain_ms": ms_pb,
         "bound_ms": bound_b, "bound_by": bound_by_b, "library_ms": None},
    ]}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()

"""One run of one cell: set-up, warm-up, the measured window, the
profiled sub-window (``--trace 1``), the checks against the plain
reference, and the result line."""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch

from perfbench.core import arith, check, manifest, trace
from perfbench.core.traffic import Traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "scavislam_tpu")


class NoCard(RuntimeError):
    pass


def forbidden_modules(modules=None) -> list:
    """Top-level names of loaded modules that a run may not load,
    compared whole (``scavislam_tpu_torch`` is not ``scavislam_tpu``)."""
    tops = {m.split(".")[0] for m in (modules if modules is not None
                                      else list(sys.modules))}
    return sorted(tops & set(FORBIDDEN))


def require_card(chips: int):
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark "
                     "measures the port on a CUDA card and has no CPU "
                     "fallback")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, "
                     f"torch.cuda.device_count() is "
                     f"{torch.cuda.device_count()}")


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


class Record:
    """What the per-layer readers read: the drivers' logs of the window
    and the trace summary (None without ``--trace 1``)."""

    def __init__(self, logs: dict, trace_summary):
        self.__dict__.update(logs)
        self.trace = trace_summary


def execute(cell_name: str, seed: int, seconds: float, traced: bool,
            device="cuda", t0: float = None, overrides: dict = None,
            program_hook=None, control: bool = False) -> dict:
    """Run the cell once; returns the result (a dict, the line's content
    before it is printed) and the check lines. `program_hook(driver)`
    runs once the program is built, before the recorder wraps its frame
    step (the tests plant faults with it); `control` reads the control
    too."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = manifest.Cell(cell_name)
    overrides = dict(overrides or {})
    params = dict(cell.traffic, **overrides.pop("traffic", {}))
    config = dict(cell.config, **overrides)
    step_check = manifest.load_check(config)
    prefix_ate = manifest.ate_align(config)
    cuda = torch.device(device).type == "cuda"
    traffic = Traffic(params, config["camera"], int(config["streams"]),
                      seed, device)
    _sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    driver = manifest.load_system(config["system"]).Driver(
        config, traffic, device, program_hook=program_hook, logs=traced)

    # -- set-up: the first frame and the warm-up frames, timed as the
    # window's frames are, so that their latencies are known
    handed_at = {}
    returned = []  # (key, seconds from hand-in to return)

    def note(handed, ret, t_a, t_b):
        for k in handed:
            handed_at[k] = t_a
        for k in ret:
            returned.append((k, t_b - handed_at[k]))

    t_a = time.perf_counter()
    handed, ret = driver.first()
    note(handed, ret, t_a, time.perf_counter())
    for _ in range(traffic.warmup_frames):
        t_a = time.perf_counter()
        handed, ret = driver.call()
        note(handed, ret, t_a, time.perf_counter())
    _sync(device)

    # -- the measured window: a closed loop, the next call when the last
    # returns; it closes at the return of the first call that ends at or
    # after the deadline, or when the rendered frames run out (those of
    # the profiled sub-window kept back)
    last = traffic.n - (traffic.trace_frames if traced else 0)
    positions = set(traffic.check_positions)
    driver.open_window()
    n_before = len(returned)
    t_w0 = time.perf_counter()
    setup_s = t_w0 - t0
    deadline = t_w0 + seconds
    attempted, pos, exhausted = [], 0, False
    t_b = t_w0
    while True:
        if driver.next >= last:
            exhausted = True
            break
        driver.arm(driver.next if pos in positions else None)
        t_a = time.perf_counter()
        handed, ret = driver.call()
        t_b = time.perf_counter()
        note(handed, ret, t_a, t_b)
        attempted += handed
        pos += 1
        if t_b >= deadline:
            break
    driver.arm(None)
    t_w1 = t_b
    driver.close_window()
    window = returned[n_before:]
    if exhausted:
        log(f"window: the {last} rendered frames ran out after "
            f"{t_w1 - t_w0:.3f} s of the {seconds} s window; it ends there")

    summary = None
    if traced:
        remaining = traffic.n - driver.next
        if remaining < traffic.trace_frames:
            log(f"trace: {remaining} frames left for the "
                f"{traffic.trace_frames} calls of the profiled sub-window")
        else:
            def traced_call():
                t_a = time.perf_counter()
                handed, ret = driver.call()
                note(handed, ret, t_a, time.perf_counter())

            summary = trace.profile_calls(traced_call, traffic.trace_frames,
                                          driver.span, lambda: _sync(device),
                                          device)
            if summary is not None:
                log(f"trace: {summary['calls']} calls, "
                    f"{summary['device_events']} device operations; the "
                    f"entry's stream {summary['entry_streams']}, its graph "
                    "launches (operations, s): "
                    f"{summary['graph_launches']}")
    returned_after = driver.close()
    _sync(device)
    got = {k for k, _ in returned} | set(returned_after)
    failed = [k for k in attempted if k not in got]
    # frames with no pose: the window's, and those of the prefix that ATE
    # is taken over
    handed_in = driver.next
    prefix = {(s, f) for s in range(len(driver.gts))
              for f in range(min(traffic.ate_frames, handed_in))}
    no_pose = (set(failed) | prefix) - got

    # -- end-to-end metrics
    lat_ms = [1e3 * s for _, s in window]
    ates = [prefix_ate(traj, gts, traffic.ate_frames)[0]
            for traj, gts in zip(driver.trajectories(), driver.gts)]
    values = {
        "frames_per_s": arith.frames_per_s(len(window), t_w1 - t_w0),
        "frame_ms_p95": arith.p95(lat_ms) if lat_ms else None,
        "ate_m": (float(np.mean(ates)) if all(a is not None for a in ates)
                  else None),
        "setup_s": setup_s,
    }
    rec = Record(driver.layer_logs(), summary)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else None

    # -- the checks: the reference on the kept inputs, after the program
    # is released
    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = check.Readings(dict(config["limits"]))
    ctl = check.Readings(dict(config["limits"])) if control else None
    t_c = time.perf_counter()
    stacks = [st for st, _ in traffic.streams]
    step_check.compare(driver.steps.samples, stacks, config, readings, ctl)
    n_checked = len(driver.steps.samples)
    if n_checked < len(traffic.check_positions):
        readings.missing.append(
            f"{n_checked} of {len(traffic.check_positions)} checked "
            "calls kept (the window closed before the rest)")
    readings.add("frames_without_pose", len(no_pose))
    if handed_in < traffic.ate_frames:
        readings.missing.append(
            f"{handed_in} frames handed in, fewer than the "
            f"{traffic.ate_frames} that ATE is taken over")
    elif values["ate_m"] is not None:
        readings.worst("stream_ate_m", max(ates))
    for k in ("frames_per_s", "frame_ms_p95", "ate_m"):
        if values[k] is None:
            readings.missing.append(f"{k} has no value")
    log(f"checks: {n_checked} calls checked against the plain reference "
        f"in {time.perf_counter() - t_c:.1f} s")

    if traced:
        metrics = {}
        for m in cell.per_layer:
            v = manifest.load_reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = {
        "correct": readings.correct,
        "attempted": len(attempted),
        "failed": len(failed),
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if cuda
                            else "cpu"),
                   "count": cell.chips if cuda else 0,
                   "memory_peak_bytes": memory_peak},
    }
    if traced and summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["window"] = {"seconds": t_w1 - t_w0, "calls": pos,
                        "poses": len(window), "exhausted": exhausted,
                        "ate_per_stream": ates,
                        "end_to_end": values}
    result["checks"] = readings.result()
    return {"result": result, "lines": readings.lines(),
            "forbidden": forbidden_modules(), "readings": readings,
            "control": ctl}


def emit(out: dict, card_line: str):
    """Print the check lines as the last lines on standard error and the
    result as the last line of standard output. Refuses anything not
    measured on a card."""
    r = out["result"]
    if r["device"]["platform"] != "gpu":
        raise NoCard("device metrics are printed only from a run on a card")
    r = dict(r)
    checks = r.pop("checks")
    r["card"] = card_line
    r["checks"] = checks  # last key: each number compared and its limit
    for line in out["lines"]:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(r), flush=True)


def main(args, t0: float) -> int:
    cell = manifest.Cell(args.workload)
    try:
        require_card(cell.chips)
    except NoCard as e:
        print(f"error: {e}", file=sys.stderr, flush=True)
        return 2
    card = _card_line()
    out = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                  device="cuda", t0=t0)
    # after the window, the reference and the per-layer readers: whatever
    # any of them loaded is in sys.modules now
    bad = forbidden_modules()
    if bad:
        print(f"error: the run loaded {bad}", file=sys.stderr, flush=True)
        return 3
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", file=sys.stderr, flush=True)
    emit(out, card)
    return 0

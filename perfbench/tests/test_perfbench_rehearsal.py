"""A rehearsal of a run's control flow on the CPU at a tiny size (the
harness's look for a card skipped), and the refusal to print a result
without a card."""

import json
import subprocess
import sys

import pytest
import torch

from perfbench.core import harness, manifest
from perfbench.tests.conftest import TINY_CAMERA, TINY_TRAFFIC

SEED = 2**31 + 977  # larger than 32 signed bits hold
# a window that only the tiny traffic's rendered frames end, however busy
# the CPU: every checked call and the whole ATE prefix are reached
WINDOW_S = 3600.0


def tiny(streams=None, **traffic):
    o = {"camera": TINY_CAMERA, "traffic": dict(TINY_TRAFFIC, **traffic)}
    if streams is not None:
        o["streams"] = streams
    return o


def kernel_route(driver):
    """The pool's program on the CPU takes the batched block matcher's
    plain version, the route a card takes (the CPU's default is the
    cost-volume twin, another algorithm than the reference's)."""
    from scavislam_tpu_torch.parallel.multistream import (
        build_multistream_frontend,
    )
    fe0 = driver.pool.fes[0]
    driver.pool.step = build_multistream_frontend(
        None, fe0._cam_params, fe0._cam_statics, levels=fe0.levels,
        num_disp=fe0._num_disp, max_reproj=2.0,
        dense_subs=fe0.dense_subs, stereo="kernel")


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines "
                    "without one")
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "nc_stereo.wander",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "no CPU fallback" in p.stderr
    for line in p.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_cpu_rehearsal_single_stream():
    out = harness.execute("nc_stereo.wander", SEED, WINDOW_S, False,
                          device="cpu", overrides=tiny())
    r = out["result"]
    assert r["correct"], out["lines"]
    assert set(r["metrics"]) == {"frames_per_s", "frame_ms_p95", "ate_m",
                                 "setup_s"}
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["metrics"]["ate_m"]["value"] < 0.1
    # every number the configuration compares, each with its limit
    limits = manifest.Cell("nc_stereo.wander").config["limits"]
    assert {k: v["limit"] for k, v in r["checks"].items()} == limits
    assert out["forbidden"] == []
    with pytest.raises(harness.NoCard):
        harness.emit(out, "cpu")


def test_cpu_rehearsal_traced_single_stream():
    out = harness.execute("nc_stereo.wander", SEED + 1, WINDOW_S, True,
                          device="cpu", overrides=tiny())
    r = out["result"]
    assert r["correct"], out["lines"]
    # the readers of host logs find their logs; the device readers find no
    # device activity on the CPU
    assert {"frontend.fetch_wait_ms", "frontend.host_ms"} <= set(
        r["metrics"])
    assert "step.kernels" not in r["metrics"]
    assert "stereo_bm_roofline" not in r["metrics"]
    assert r["device"]["busy_s"] == 0.0


def test_cpu_rehearsal_pool():
    out = harness.execute("fleet8.wander", SEED, WINDOW_S, True, device="cpu",
                          overrides=tiny(streams=2, check_frames=3, check_span=4),
                          program_hook=kernel_route)
    r = out["result"]
    assert r["correct"], out["lines"]
    assert {"pool.fetch_wait_ms", "pool.consume_ms"} <= set(r["metrics"])
    assert len(r["window"]["ate_per_stream"]) == 2

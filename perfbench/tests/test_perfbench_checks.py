"""What a configuration names for its cell: the step comparison that
decides ``correct`` (``"step_check"``, a module of ``perfbench/checks``)
and the alignment that ATE is taken under (``"ate_align"``); the faults
reach the step through the driver's ``step_site`` and the comparison's
``take_state``."""

import subprocess
import sys
import types
from collections import namedtuple

import numpy as np
import pytest
import torch

from perfbench.core import arith, faults, harness, manifest
from perfbench.gen import synthetic
from perfbench.tests.conftest import TINY_TRAFFIC
from perfbench.tests.test_perfbench_metrics import _gt, _pose
from perfbench.tests.test_perfbench_rehearsal import (
    SEED,
    WINDOW_S,
    kernel_route,
    tiny,
)

NC = manifest.Cell("nc_stereo.wander").config
MISSING = object()


def probe_check(seen: dict):
    """A step comparison of the test's own, registered under
    perfbench.checks: it counts what reaches each of its functions."""
    mod = types.ModuleType("perfbench.checks.probe_step")
    seen.update(take_state=0, keep_out=0, compare=[])

    def take_state(args, kwargs):
        seen["take_state"] += 1
        return {"args": len(args)}

    def keep_out(out):
        seen["keep_out"] += 1
        return {"R": out.R_cw.detach().clone()}

    def compare(samples, stacks, config, readings, control):
        seen["compare"].append(list(samples))
        for k in ("disp_mismatch_px", "step_pose_gap_median",
                  "step_pose_gap"):
            readings.worst(k, 0.0)

    mod.take_state, mod.keep_out, mod.compare = take_state, keep_out, compare
    return mod


def test_a_named_comparison_takes_every_kept_sample(monkeypatch):
    from perfbench.checks import stereo_step
    from perfbench.reference import frame

    def unreachable(*a, **k):
        raise AssertionError("the stereo comparison was reached")

    seen = {}
    monkeypatch.setitem(sys.modules, "perfbench.checks.probe_step",
                        probe_check(seen))
    for mod, name in ((frame, "frame_pose"), (stereo_step, "take_state"),
                      (stereo_step, "keep_out"), (stereo_step, "compare")):
        monkeypatch.setattr(mod, name, unreachable)
    out = harness.execute("nc_stereo.wander", SEED, WINDOW_S, False,
                          device="cpu",
                          overrides=dict(tiny(), step_check="probe_step"))
    assert out["result"]["correct"], out["lines"]
    n = TINY_TRAFFIC["check_frames"]
    assert seen["take_state"] == seen["keep_out"] == n
    (samples,) = seen["compare"]
    assert len(samples) == n
    assert all(set(state) == {"args"} and set(o) == {"R"}
               for _, state, o in samples)
    assert len({tag for tag, _, _ in samples}) == n


def _without(key, value):
    cfg = dict(NC)
    if value is MISSING:
        del cfg[key]
    else:
        cfg[key] = value
    return cfg


BAD = [("step_check", MISSING), ("step_check", "no_such_check"),
       ("step_check", "../core/arith"), ("step_check", None),
       ("ate_align", MISSING), ("ate_align", "umeyama"),
       ("ate_align", ["sim3"])]


@pytest.mark.parametrize("key,value", BAD)
def test_a_cell_whose_config_lacks_a_known_name_is_refused(monkeypatch, key,
                                                           value):
    cfg = _without(key, value)
    monkeypatch.setattr(manifest, "_load_json", lambda rel: dict(cfg))
    with pytest.raises(manifest.ConfigError, match=f"'{key}'"):
        manifest.Cell("nc_stereo.wander")


@pytest.mark.parametrize("key,value", [("step_check", "no_such_check"),
                                       ("ate_align", "unaligned")])
def test_a_run_refuses_an_unknown_name_before_it_renders(monkeypatch, key,
                                                         value):
    from perfbench.core import traffic

    def unreachable(*a, **k):
        raise AssertionError("the traffic was rendered")

    monkeypatch.setattr(traffic, "render_stream", unreachable)
    with pytest.raises(manifest.ConfigError, match=f"'{key}'"):
        harness.execute("nc_stereo.wander", SEED, WINDOW_S, False,
                        device="cpu", overrides=dict(tiny(), **{key: value}))


def test_a_comparison_lacking_a_function_is_refused(monkeypatch):
    mod = probe_check({})
    del mod.keep_out
    monkeypatch.setitem(sys.modules, "perfbench.checks.probe_step", mod)
    with pytest.raises(manifest.ConfigError, match="keep_out"):
        manifest.load_check({"step_check": "probe_step"})


@pytest.mark.parametrize("conf", [c["file"] for c in manifest.load()
                                  ["configs"]])
def test_each_configuration_names_its_parts(conf):
    import json

    cfg = json.loads((manifest.ROOT / conf).read_text())
    mod = manifest.load_check(cfg)
    assert (manifest.BENCH_DIR / "checks"
            / f"{cfg['step_check']}.py").is_file()
    assert mod.__name__ == f"perfbench.checks.{cfg['step_check']}"
    assert manifest.ate_align(cfg) is arith.ALIGNMENTS[cfg["ate_align"]]


def test_the_comparisons_load_nothing_of_the_port():
    mods = sorted(p.stem for p in (manifest.BENCH_DIR / "checks").glob(
        "*.py") if p.stem != "__init__")
    code = "".join(f"import perfbench.checks.{m}\n" for m in mods)
    code += ("import perfbench.core.arith, perfbench.core.manifest\n"
             "import sys\nprint(sorted({m.split('.')[0] for m in "
             "sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=300)
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert mods and not tops & {"scavislam_tpu_torch", "scavislam_tpu",
                                "jax", "jaxlib", "flax"}


# -- ATE under each alignment ----------------------------------------------

def _rotation(axis, angle):
    k = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def _centres(gt):
    return np.stack([-T.R.numpy().astype(np.float64).T
                     @ T.t.numpy().astype(np.float64) for T in gt])


def _estimate(gt, centres, s, Q, u):
    """Poses whose camera centres are s Q c + u for `centres`, with the
    ground truth's orientations in the world frame that maps to."""
    est = []
    for T, c in zip(gt, centres):
        # orthonormal in float64 (the float32 rotation is not, to 1e-7),
        # so that -R^T t gives back the centre exactly
        U, _, Vt = np.linalg.svd(T.R.numpy().astype(np.float64) @ Q.T)
        R = U @ Vt
        est.append(types.SimpleNamespace(R=R, t=-R @ (s * Q @ c + u)))
    return est


GT = synthetic.make_trajectory(60, "wander", 0.06)
Q0 = _rotation([0.3, -1.0, 0.4], 1.1)
U0 = np.array([2.0, -0.5, 7.0])


def test_sim3_reads_nothing_on_a_similar_copy():
    est = _estimate(GT, _centres(GT), 3.0, Q0, U0)
    traj = list(enumerate(est))
    rmse, n = arith.prefix_sim3_ate(traj, GT, 50)
    assert n == 50 and rmse < 1e-9
    # unaligned, the same poses are metres off
    assert arith.prefix_ate(traj, GT, 50)[0] > 1.0


def test_sim3_reads_the_known_rmse_of_a_perturbation():
    """Centres moved by d, with d of zero mean and uncorrelated with the
    centred path: the best similarity is the scale A / (A + B) alone (A,
    B the sums of squares of path and d), leaving an RMSE of
    sqrt(A B / (n (A + B)))."""
    c = _centres(GT)
    n = len(c)
    basis, _ = np.linalg.qr(np.column_stack([np.ones(n), c - c.mean(0)]))
    d = np.random.default_rng(5).normal(0.0, 0.05, (n, 3))
    d -= basis @ (basis.T @ d)
    A = ((c - c.mean(0)) ** 2).sum()
    B = (d ** 2).sum()
    want = np.sqrt(A * B / (n * (A + B)))
    est = _estimate(GT, c + d, 0.4, Q0, U0)
    got, m = arith.prefix_sim3_ate(list(enumerate(est)), GT, n)
    assert m == n and got == pytest.approx(want, rel=1e-9)
    assert 0.05 < got < 0.1


def test_sim3_of_a_run_that_never_moves_is_the_spread_of_the_truth():
    """Every frame at the pose the run started from: no similarity maps
    one place onto a path; the fit leaves the truth's spread about its
    centroid."""
    c = _centres(GT)
    (stuck,) = _estimate(GT[:1], c[:1], 1.0, Q0, U0)
    got, _ = arith.prefix_sim3_ate([(i, stuck) for i in range(len(c))], GT,
                                   len(c))
    want = np.sqrt(((c - c.mean(0)) ** 2).sum(axis=1).mean())
    assert got == pytest.approx(want, rel=1e-12)


def parent_prefix_ate(trajectory, gt, ate_frames: int):
    """`arith.prefix_ate` as it stood before the alignments were named."""
    pairs = sorted(((fid, T) for fid, T in trajectory if fid < ate_frames),
                   key=lambda e: e[0])
    if not pairs:
        return None, 0
    rmse = arith.ate([T for _, T in pairs], [gt[fid] for fid, _ in pairs])
    return rmse, len(pairs)


def _metric_test_trajectories():
    gt = {i: _gt([0.0, 0.0, 0.0]) for i in range(11)}
    traj = [(i, _pose([0.1, 0.0, 0.0])) for i in range(4)]
    traj += [(i, _pose([5.0, 0.0, 0.0])) for i in range(4, 10)]
    noisy = _estimate(GT, _centres(GT) + 0.01 * np.sin(
        np.arange(len(GT)))[:, None], 1.0, np.eye(3), np.zeros(3))
    return [(traj, gt, 4), (traj + [(10, _pose([9, 9, 9]))], gt, 4),
            (traj, gt, 10), (traj[::-1], gt, 7), ([], gt, 4),
            (list(enumerate(noisy))[::-1], GT, 45)]


@pytest.mark.parametrize("case", range(6))
def test_first_frame_is_the_parents_prefix_ate(case):
    traj, gt, k = _metric_test_trajectories()[case]
    align = manifest.ate_align({"ate_align": "first_frame"})
    assert align(traj, gt, k) == parent_prefix_ate(traj, gt, k)


# -- faults through the driver's step site ---------------------------------

Out = namedtuple("Out", "packed R_cw t_cw")


def _site_driver():
    """A driver whose step, reached by `step_site`, hands its pose by
    keyword: the faults can find it only through `take_state`."""
    B = 4
    g = torch.Generator().manual_seed(3)
    R_new, t_new = torch.randn(B, 3, 3, generator=g), torch.randn(
        B, 3, generator=g)
    owner = types.SimpleNamespace()
    owner.step = lambda **kw: Out(torch.zeros(B, 20), R_new, t_new)
    check = types.SimpleNamespace(
        take_state=lambda args, kwargs: {"R": kwargs["R_prev"],
                                         "t": kwargs["t_prev"]})
    return types.SimpleNamespace(step_site=(owner, "step"), check=check,
                                 owner=owner, R_new=R_new, t_new=t_new)


@pytest.mark.parametrize("fault,kept", [("state_unchanged", slice(0, 0)),
                                        ("half_batch", slice(0, 2)),
                                        ("one_lane", slice(0, 3))])
def test_pose_faults_take_the_handed_pose_from_take_state(fault, kept):
    d = _site_driver()
    faults.plant(fault)(d)
    R0, t0 = torch.eye(3).expand(4, 3, 3), torch.zeros(4, 3)
    out = d.owner.step(R_prev=R0, t_prev=t0)
    lanes = range(4)[kept]
    for s in range(4):
        R_want = d.R_new[s] if s in lanes else R0[s]
        t_want = d.t_new[s] if s in lanes else t0[s]
        assert torch.equal(out.R_cw[s], R_want)
        assert torch.equal(out.t_cw[s], t_want)
        assert torch.equal(out.packed[s, :9], R_want.reshape(9))
        assert torch.equal(out.packed[s, 9:12], t_want)


@pytest.mark.parametrize("fault", ["state_unchanged", "pose_lost"])
def test_pool_fault_through_the_site_is_not_correct(fault):
    out = harness.execute("fleet8.wander", SEED, WINDOW_S, False, device="cpu",
                          overrides=tiny(streams=2, check_frames=3,
                                         check_span=4),
                          program_hook=faults.plant(fault, kernel_route))
    assert not out["result"]["correct"], out["lines"]
    rd = out["readings"]
    assert any(rd.values.get(k, 0.0) > lim for k, lim in rd.limits.items())

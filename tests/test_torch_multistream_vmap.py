"""The multistream steps as one vmapped program
(scavislam_tpu_torch.parallel.multistream): each lane of the batched
stereo and mono steps against the port's single-stream step from the same
lane state, the stream axis's independence, one program per call with no
per-sample vmap fallback, and (slow) the twin's own vmapped programs on
the same numpy state.

The batched program rounds differently from a single-stream step (vmap
turns matrix products into batched ones, which sum in another order), so
the lanes are held within bars, not bit for bit:
- stereo: the packed vector within 2e-4 plus 1e-6 relative (the twin
  route's bar against JAX, test_torch_multistream.py), R_cw and t_cw
  within 1e-6, or, on the twin route (stereo method 1, whose motion-only
  BA is weakly constrained in t_y on stream 1), within WITNESS_MARGIN
  times the single-stream step's own move when its f32 state moves by
  one ulp (test_torch_multistream.py::rounding_spread), where that is
  larger;
- mono: each leaf (packed head, post-update information, psi, Lambda)
  within 1e-5, or within WITNESS_MARGIN times the single-stream step's
  own one-ulp move where that is larger
  (test_torch_multistream.py::mono_bars). The mono motion-only LM accepts
  steps whose gain is a few ulps of chi2, so a rounding difference can
  take it down another accept path, and the depth filter amplifies the
  pose's move. test_mono_stages_depart_by_rounding shows where the
  batched program departs: each stage, vmapped over the lanes' own
  inputs, is within 1e-6 of the single-stream stage.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scavislam_tpu_torch import interop
from scavislam_tpu_torch.core.lie import SE3
from scavislam_tpu_torch.models.frontend_step import (
    DENSE_SUBS_BATCHED,
    frontend_step,
)
from scavislam_tpu_torch.models import mono_step as mono_step_module
from scavislam_tpu_torch.models.dense_tracker import lanes
from scavislam_tpu_torch.models.mono_step import mono_step
from scavislam_tpu_torch.parallel import multistream
from scavislam_tpu_torch.parallel.multistream import (
    build_multistream_frontend,
    build_multistream_mono,
    stack_streams,
    stream_slice,
)
from test_torch_multistream import (  # noqa: F401 (fixtures)
    WITNESS_MARGIN,
    _cams,
    _one_torch_thread,
    batch,
    hold_mono,
    mono_bars,
    rounding_spread,
)

B = 2
CPU = torch.device("cpu")
ROUTES = {"kernel": 2, "twin": 1}  # route -> the single-stream method
RT_BAR = 1e-6
PACKED_ATOL, PACKED_RTOL = 2e-4, 1e-6
# the single-stream stereo step's f32 state: the dense state (clouds,
# intensities, template Jacobians), the previous pose, the pose and point
# tables
STEREO_STATE = (1, 2, 4, 5, 6, 8, 9)
STEREO_DRAWS = 4


def _step(route):
    cam_params, cam_statics = _cams()
    return build_multistream_frontend(
        None, cam_params, cam_statics, levels=3, num_disp=64,
        max_reproj=2.0, dense_subs=DENSE_SUBS_BATCHED, dense_sample="qpack",
        stereo=route)


def _args(tb, order):
    """The batched step's arguments for the streams in `order`."""
    idx = torch.as_tensor(order)
    pick = lambda x: stack_streams([stream_slice(x, s) for s in order])  # noqa: E731
    return (tb["frames"][idx], *pick(tb["dense"]), tb["R"][idx],
            tb["t"][idx], [tb["ak"][s] for s in order], pick(tb["poses"]),
            pick(tb["points"]), tb["cand"][idx])


def _lane(args, s):
    """Lane `s` of batched arguments, as the single-stream step takes
    them."""
    return tuple(a[s] if isinstance(a, list) else stream_slice(a, s)
                 for a in args)


def _single(args, route):
    """The port's single-stream step on one lane's arguments."""
    cam_params, cam_statics = _cams()
    return frontend_step(
        *args, cam_params, cam_statics, 3, 64, False, 2.0, ROUTES[route],
        dense_subs=DENSE_SUBS_BATCHED)


def _pose(out):
    return {"R": out.R_cw, "t": out.t_cw}


def _hold(out, s, ref, bars=None):
    """Lane `s` of a batched stereo step within the bars of `ref` (R_cw and
    t_cw within `bars`, by default RT_BAR), with the same gates."""
    bars = bars or {"R": RT_BAR, "t": RT_BAR}
    for k, got in _pose(out).items():
        d = float(torch.abs(got[s] - _pose(ref)[k]).max())
        assert d <= bars[k], (k, d, bars[k])
    np.testing.assert_allclose(out.packed[s].numpy(), ref.packed.numpy(),
                               atol=PACKED_ATOL, rtol=PACKED_RTOL)
    assert torch.equal(out.gate[s], ref.gate)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_lanes_match_single_stream(batch, route):
    # (a) measured, one intra-op thread (R, t, packed): kernel route lane
    # 0 3.0e-8, 2.0e-7, 1.9e-5, lane 1 7.9e-9, 5.2e-8, 1.5e-5; twin route
    # lane 0 5.6e-8, 6.9e-7, 6.7e-5, lane 1 1.8e-6, 1.0e-5, 5.7e-5, where
    # the single-stream step itself moves R and t by 1.6e-5 and 9.5e-5
    # over STEREO_DRAWS one-ulp moves of its state; the packed maxima are
    # pixel coordinates of 100-250 px moved by a few f32 ulps
    _, tb = batch
    args = _args(tb, [0, 1])
    out = _step(route)(*args)
    for s in range(B):
        lane = _lane(args, s)
        ref = _single(lane, route)
        assert ref.packed[25] > 100  # a real tracking problem
        bars = None
        if route == "twin":
            spread = rounding_spread(lambda *a: _single(a, route), lane,
                                     STEREO_STATE, _pose, STEREO_DRAWS)
            bars = {k: max(RT_BAR, WITNESS_MARGIN * v)
                    for k, v in spread.items()}
        _hold(out, s, ref, bars)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_reversed_streams_reverse_the_outputs(batch, route):
    # (b) the same streams in reverse order: each lane within the bars of
    # the forward batch's lane of the same stream (measured: equal)
    _, tb = batch
    step = _step(route)
    fwd = step(*_args(tb, [0, 1]))
    rev = step(*_args(tb, [1, 0]))
    for s in range(B):
        ref = stream_slice(fwd, s)
        _hold(rev, B - 1 - s, ref)


def test_dead_lane_leaves_the_other_alone(batch):
    # (c) lane 1 black with every candidate -1: lane 0 within the bars of
    # its B = 1 run (measured: R 2.9e-8, t 2.7e-7, packed 1.5e-5), and
    # the dead lane gates nothing
    _, tb = batch
    step = _step("kernel")
    args = list(_args(tb, [0, 1]))
    args[0] = args[0].clone()
    args[0][1] = 0
    args[10] = args[10].clone()
    args[10][1] = -1
    out = step(*args)
    alone = step(*_args(tb, [0]))
    _hold(out, 0, stream_slice(alone, 0))
    assert int(out.n_gated[1]) == 0 and not bool(out.gate[1].any())
    assert bool(torch.isfinite(out.R_cw[1]).all())


@pytest.fixture
def strict_vmap():
    """vmap's per-sample fallback warns, and every warning raises."""
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            yield
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*a, **k):
        calls.append(1)
        return fn(*a, **k)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_one_program_per_call(batch, route, monkeypatch, strict_vmap):
    # (d) frontend_step entered once per batched call, not once per
    # stream, with no per-sample fallback
    _, tb = batch
    calls = _count_calls(monkeypatch, multistream, "frontend_step")
    out = _step(route)(*_args(tb, [0, 1]))
    assert len(calls) == 1
    assert out.packed.shape[0] == B


def test_lms_inside_vmap(strict_vmap):
    # in `lanes` (the batched steps' vmapped program) the fixed-trip LMs
    # run every trip (their stop differs per stream), and a card's batched
    # solve is two triangular solves (the batched cholesky_solve there runs
    # MAGMA, which a CUDA graph capture refuses): on the CPU that route
    # batches without a fallback and agrees with cholesky_solve (measured:
    # equal)
    from scavislam_tpu_torch.models import dense_tracker as tdt

    assert tdt.lm_exits_early(CPU)
    with lanes():
        assert not tdt.lm_exits_early(CPU)
    assert tdt.lm_exits_early(CPU)
    rng = np.random.RandomState(0)
    A = torch.as_tensor(rng.randn(8, 6, 6).astype(np.float32))
    H = A @ A.mT + torch.eye(6)
    b = torch.as_tensor(rng.randn(8, 6, 1).astype(np.float32))
    L = torch.linalg.cholesky(H)
    x = torch.func.vmap(tdt._triangular_solves)(b, L)
    ref = torch.cholesky_solve(b, L)
    np.testing.assert_allclose(x.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.fixture(scope="module")
def mono_batch():
    """Two mono streams after two frames of short real runs at the twin's
    128x96 mono camera (different step sizes; tests/test_parallel.py's
    TestMultistreamMono), with frame 2's images: the batched step's
    arguments and the state as numpy for the twin."""
    from scavislam_tpu_torch.io.synthetic import SyntheticSequence
    from scavislam_tpu_torch.models.mono_frontend import MonoFrontend

    cam = interop.camera(130.0, (63.5, 47.5), (128, 96), 0.12)
    fes, imgs = [], []
    for s in range(B):
        seq = SyntheticSequence(cam, n_frames=3, kind="forward_arc",
                                step=0.03 + 0.01 * s, device=CPU)
        fe = MonoFrontend(cam, device=CPU)
        fe.process_first_frame(seq.frame(0))
        ok, _ = fe.process_frame(seq.frame(1))
        assert ok
        fes.append(fe)
        imgs.append(seq.frame(2)["left"])
    cands = [torch.as_tensor(fe._collect_candidates().astype(np.int32))
             for fe in fes]
    args = (torch.stack(imgs),
            torch.stack([torch.as_tensor(fe._R_cw) for fe in fes]),
            torch.stack([torch.as_tensor(fe._t_cw) for fe in fes]),
            torch.tensor([max(fe.actkey_id, 0) for fe in fes],
                         dtype=torch.int32),
            stack_streams([fe.poses for fe in fes]),
            stack_streams([fe.points for fe in fes]),
            torch.stack([fe.Lam for fe in fes]), torch.stack(cands),
            torch.full((B,), fes[0].conv_q_info),
            torch.full((B,), fes[0].prior_weight))
    return fes, args


def _mono_lane(args, s):
    return tuple(stream_slice(a, s) for a in args)


def test_mono_lanes_match_single_stream(mono_batch, monkeypatch,
                                        strict_vmap):
    # (e) the batched mono step: one mono_step call per batched call, no
    # fallback, each lane against mono_step from its state, within
    # `mono_bars`. Measured, lane against the single-stream step's own
    # largest move over WITNESS_DRAWS one-ulp moves of its state (packed
    # head, information, psi, Lambda): lane 0 1.73e-5 / 1.73e-5, 2.88e-2 /
    # 2.86e-2, 6.8e-4 / 6.8e-4, 1.73 / 1.73; lane 1 6.6e-7 / 7.6e-6,
    # 1.7e-3 / 1.3e-2, 7.6e-3 / 4.7e-2, 34.1 / 215; gates equal
    fes, args = mono_batch
    calls = _count_calls(monkeypatch, multistream, "mono_step")
    step = build_multistream_mono(None, fes[0]._cam_params,
                                  fes[0]._cam_statics, levels=3)
    out = step(*args)
    assert len(calls) == 1
    monkeypatch.undo()
    cams = (fes[0]._cam_params, fes[0]._cam_statics)
    for s in range(B):
        lane = _mono_lane(args, s)
        ref = mono_step(*lane, *cams, 3, 2.0, 0.18)
        assert ref.packed[25] >= 15  # the frame tracks
        hold_mono(stream_slice(out, s), ref, mono_bars(lane, *cams))


def test_mono_stages_depart_by_rounding(mono_batch, monkeypatch):
    # where the batched mono step departs from the single-stream step:
    # each stage that reduces (both motion-only BAs, the depth filter),
    # vmapped in `lanes` over the inputs the single-stream step gave it in
    # each lane. The second BA and the filter are within 1e-6 of their
    # single-stream results (relative where a value exceeds 1: Lambda
    # holds 1e4 bearing information); measured: equal.
    # The first BA departs: its LM accepts steps whose gain is a few ulps
    # of chi2, so rounding takes it down another accept path. It moves no
    # further than WITNESS_MARGIN times the single-stream BA's own move
    # over WITNESS_DRAWS one-ulp moves of its f32 inputs (starting pose,
    # points, observations, weights). Measured, lane against that move:
    # lane 0 R 4.2e-6 / 4.3e-6, t 1.73e-5 / 1.76e-5; lane 1 6.7e-8 /
    # 9.0e-7, 2.9e-7 / 4.0e-6
    fes, args = mono_batch
    cams = (fes[0]._cam_params, fes[0]._cam_statics)
    calls = {"ba": [], "filter": []}
    ba = mono_step_module.motion_only_ba_uv
    filt = mono_step_module.filter_points_info

    def record_ba(cam, T, *a):
        res = ba(cam, T, *a)
        calls["ba"].append((cam, (T.R, T.t, *a[:4]), (res.T.R, res.T.t)))
        return res

    def record_filter(cam, *a, **k):
        res = filt(cam, *a, **k)
        calls["filter"].append((cam, a, (res.psi, res.Lambda)))
        return res

    monkeypatch.setattr(mono_step_module, "motion_only_ba_uv", record_ba)
    monkeypatch.setattr(mono_step_module, "filter_points_info",
                        record_filter)
    for s in range(B):
        mono_step(*_mono_lane(args, s), *cams, 3, 2.0, 0.18)
    monkeypatch.undo()

    def run_ba(cam, R, t, *a):
        res = ba(cam, SE3(R, t), *a, 1.0)
        return res.T.R, res.T.t

    def run_filter(cam, *a):
        return tuple(filt(cam, *a, iters=5)[:2])

    stages = [("ba", run_ba, True), ("ba", run_ba, False),
              ("filter", run_filter, False)]
    for k, (name, run, departs) in enumerate(stages):
        n = 2 if name == "ba" else 1
        rows = calls[name][k % 2 if name == "ba" else 0::n]
        assert len(rows) == B
        cam = rows[0][0]
        ins = [torch.stack(x) for x in zip(*(r[1] for r in rows))]
        with lanes():
            outs = torch.func.vmap(lambda *a: run(cam, *a))(*ins)
        for s, (_, lane_in, want) in enumerate(rows):
            bar = 1e-6
            if departs:
                spread = rounding_spread(
                    lambda *a: run(cam, *a), lane_in, range(len(lane_in)),
                    lambda out: dict(enumerate(out)))
                bar = max(bar, WITNESS_MARGIN * max(spread.values()))
            for got, ref in zip(outs, want):
                d = float((torch.abs(got[s] - ref)
                           / torch.clamp(torch.abs(ref), min=1.0)).max())
                assert d <= bar, (name, k, s, d, bar)


# -- the twin's own vmapped programs (compile-bound, slow in the twin too:
# tests/test_parallel.py:114, :198)

@pytest.mark.slow
def test_stereo_matches_the_twins_vmapped_program(batch):
    # (f) the twin route against scavislam_tpu's build_multistream_frontend
    # (stereo method 1 on the CPU, exact sampler) on the same numpy state.
    # Measured: packed 3.1e-5 (stream 0) and 1.1e-4 (stream 1), R_cw and
    # t_cw 2.2e-7 and 3.6e-5
    from scavislam_tpu.parallel import multistream as jms

    streams, tb = batch
    cam_params, cam_statics = _cams()
    jstep = jms.build_multistream_frontend(
        None, cam_params, cam_statics, levels=3, num_disp=64,
        max_reproj=2.0, dense_subs=DENSE_SUBS_BATCHED, dense_sample="qpack")
    n = np.asarray
    j = lambda x: jax.tree.map(jnp.asarray, x)  # noqa: E731
    jargs = [jnp.asarray(n(tb["frames"]))]
    jargs += [j(tuple(n(x) for x in part)) for part in tb["dense"]]
    jargs += [jnp.asarray(n(tb["R"])), jnp.asarray(n(tb["t"])),
              jnp.asarray(np.array(tb["ak"], np.int32))]
    jargs += [j(type(tb[k])(*(n(x) for x in tb[k])))
              for k in ("poses", "points")]
    jargs += [jnp.asarray(n(tb["cand"]))]
    from scavislam_tpu.models.map_store import PointTable as JPt
    from scavislam_tpu.models.map_store import PoseTable as JPo
    jargs[8] = JPo(*jargs[8])
    jargs[9] = JPt(*jargs[9])
    ref = n(jstep(*jargs).packed)
    out = _step("twin")(*_args(tb, [0, 1]))
    for s in range(B):
        np.testing.assert_allclose(out.packed[s].numpy(), ref[s],
                                   atol=PACKED_ATOL, rtol=PACKED_RTOL)


@pytest.mark.slow
def test_mono_matches_the_twins_vmapped_program(mono_batch):
    # (f) the batched mono step against scavislam_tpu's
    # build_multistream_mono on the same numpy state, at the twin's own
    # bars for its vmapped mono step (tests/test_parallel.py:273-277).
    # Measured: pose 1.8e-5, packed head 1.8e-5, post-update information
    # 2.9e-2 (4.4e-3 relative)
    from scavislam_tpu.models.map_store import PointTable as JPt
    from scavislam_tpu.models.map_store import PoseTable as JPo
    from scavislam_tpu.parallel import multistream as jms

    fes, args = mono_batch
    n = np.asarray
    imgs, R, t, ak, poses, points, Lam, cand, conv, pw = args
    jstep = jms.build_multistream_mono(None, fes[0]._cam_params,
                                       fes[0]._cam_statics, levels=3)
    ref = n(jstep(
        jnp.asarray(n(imgs)), jnp.asarray(n(R)), jnp.asarray(n(t)),
        jnp.asarray(n(ak)), JPo(*(jnp.asarray(n(x)) for x in poses)),
        JPt(*(jnp.asarray(n(x)) for x in points)), jnp.asarray(n(Lam)),
        jnp.asarray(n(cand)), jnp.asarray(n(conv)),
        jnp.asarray(n(pw))).packed)
    out = build_multistream_mono(None, fes[0]._cam_params,
                                 fes[0]._cam_statics, levels=3)(*args)
    C = cand.shape[1]
    head = 34 + 4 * C
    for s in range(B):
        p = out.packed[s].numpy()
        np.testing.assert_allclose(p[:head], ref[s, :head], atol=1e-4)
        np.testing.assert_allclose(p[head:], ref[s, head:], rtol=1e-3,
                                   atol=5e-3)

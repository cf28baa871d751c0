"""The batched multistream steps (scavislam_tpu_torch.parallel.multistream)
against the JAX package on the CPU.

- ``tracking_core`` against ``jax.vmap`` of the twin's ``_tracking_core``
  (``sp_axis=None``) on the problem of ``tests/test_parallel.py``;
- the batched frontend step's twin route (stereo method 1 per stream, the
  JAX package's CPU path) against JAX ``frontend_step`` per stream from the
  same state, at the batched density and the exact sampler;
- its kernel route (the batched block-matching kernel's plain version on
  the CPU) against the port's own single-stream method-2 step: the two
  stereo semantics agree only statistically (tests/test_ops_stereo.py), so
  each route is held against its own kind.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from scavislam_tpu.core.camera import StereoCamera as JCam
from scavislam_tpu.core.lie import SE3 as JSE3
from scavislam_tpu.io.synthetic import SyntheticSequence, default_room, varied_box
from scavislam_tpu.models.frontend import StereoFrontend as JFrontend
from scavislam_tpu.models.frontend_step import DENSE_SUBS_BATCHED as J_SUBS_B
from scavislam_tpu.parallel.multistream import _tracking_core
from scavislam_tpu.utils.config import Config as JConfig
from scavislam_tpu_torch import interop
from scavislam_tpu_torch.core.lie import SE3
from scavislam_tpu_torch.models.frontend import _to_u8
from scavislam_tpu_torch.models.frontend_step import (
    DENSE_SUBS_BATCHED,
    frontend_step,
)
from scavislam_tpu_torch.models.mono_step import mono_step
from scavislam_tpu_torch.ops import stereo_bm
from scavislam_tpu_torch.parallel.multistream import (
    build_multistream_frontend,
    build_multistream_step,
    make_mesh,
    stack_streams,
    stream_slice,
    tracking_core,
)
from scavislam_tpu_torch.parallel.stream_pool import StreamPool

J_CAM = JCam.create(195.0, (127.0, 95.0), (256, 192), 0.12)
T_CAM = interop.camera(np.asarray(J_CAM.focal), np.asarray(J_CAM.pp),
                       J_CAM.size, np.asarray(J_CAM.baseline))
CAM_PARAMS = (195.0, 127.0, 95.0, 0.12)
B = 2
CPU = torch.device("cpu")
# a lane of a batched step against the single-stream step from the same
# state: each mono leaf within 1e-5 (the packed bar of the per-stream loop
# the batched program replaced), or, where the single-stream step itself
# moves a leaf further when its f32 state moves by one ulp, within
# WITNESS_MARGIN times that move (`rounding_spread`)
MONO_BAR = 1e-5
WITNESS_DRAWS = 8
WITNESS_MARGIN = 2.0
# mono_step's f32 state (the previous pose, the pose, point and Lambda
# tables), the arguments `rounding_spread` moves
MONO_STATE = (1, 2, 4, 5, 6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the port issues thousands of small eager ops per
    frame, and with a test process per core torch's default of a thread per
    core in every process oversubscribes the machine (measured ~17x slower
    for two of these files in two processes on 8 cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(B=4, N=256, seed=0):
    """tests/test_parallel.py's make_problem, as numpy arrays."""
    key = jax.random.PRNGKey(seed)
    ks = jax.random.split(key, 4)
    xyz = jnp.stack(
        [jax.random.normal(ks[0], (B, N)) * 1.5,
         jax.random.normal(ks[1], (B, N)) * 1.0,
         jax.random.uniform(ks[2], (B, N)) * 5 + 3], axis=-1)
    T_gt = [JSE3.exp(jax.random.normal(jax.random.fold_in(key, i), (6,)) * 0.1)
            for i in range(B)]
    obs = jnp.stack([J_CAM.map_uvu(T.apply(xyz[i])) for i, T in enumerate(T_gt)])
    n = np.array  # writable copies
    return dict(
        R=np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)).copy(),
        t=np.zeros((B, 3), np.float32), xyz=n(xyz), obs=n(obs),
        w=np.ones((B, N), np.float32), v=np.ones((B, N), bool),
        T_gt=[(n(T.R), n(T.t)) for T in T_gt])


def test_tracking_core_matches_jax_and_recovers_poses():
    # the twin's core, vmapped over 4 streams of 256 points, 10 iterations:
    # R, t within 1e-5 (f32 normal equations summed in another order),
    # chi2 within 1e-5; and the poses are the ground truth within 1e-3
    p = _problem()
    iters = 10
    Rj, tj, cj = jax.vmap(
        lambda R, t, x, o, w, v: _tracking_core(CAM_PARAMS, R, t, x, o, w, v,
                                                iters, sp_axis=None)
    )(*(jnp.asarray(p[k]) for k in ("R", "t", "xyz", "obs", "w", "v")))
    Rt, tt, ct = tracking_core(
        CAM_PARAMS, *(torch.as_tensor(p[k]) for k in
                      ("R", "t", "xyz", "obs", "w", "v")), iters=iters)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5)
    for i, (Rg, tg) in enumerate(p["T_gt"]):
        T = SE3(Rt[i], tt[i]) @ SE3(torch.as_tensor(Rg),
                                    torch.as_tensor(tg)).inverse()
        assert float(torch.max(torch.abs(T.log()))) < 1e-3, i
    # the builder is the same core
    step = build_multistream_step(None, CAM_PARAMS, iters=iters)
    Rs, ts, _ = step(*(torch.as_tensor(p[k]) for k in
                       ("R", "t", "xyz", "obs", "w", "v")))
    assert torch.equal(Rs, Rt) and torch.equal(ts, tt)


def _cfg(method):
    cfg = JConfig()
    return dataclasses.replace(cfg, ui=dataclasses.replace(cfg.ui, stereo_method=method))


@pytest.fixture(scope="module")
def batch():
    """Two streams (default_room, varied_box(1)) after their first frame in
    the JAX frontend at the batched density, stereo method 1; per stream the
    state as numpy and JAX's own step on frame 1 from it (exact sampler)."""
    streams = []
    for planes in (default_room(), varied_box(1)):
        seq = SyntheticSequence(J_CAM, n_frames=2, planes=planes)
        f0, f1 = (seq.frame(i) for i in range(2))
        host = lambda f, i: {"frame_id": i, "left": np.array(f["left"]),  # noqa: E731
                             "right": np.array(f["right"])}
        fe = JFrontend(J_CAM, _cfg(1))
        fe.dense_subs = J_SUBS_B
        fe.process_first_frame(host(f0, 0))
        cand = fe._collect_candidates()
        n = np.asarray
        st = dict(
            poses=[n(fe.poses.R), n(fe.poses.t), n(fe.poses.valid)],
            points=[n(x) for x in fe.points],
            dense=[[n(x) for x in fe._prev_clouds],
                   [n(x) for x in fe._prev_intens],
                   [n(x) for x in fe._prev_valids], [n(x) for x in fe._prev_J]],
            R=n(fe._dev_R_cw), t=n(fe._dev_t_cw), ak=fe.actkey_id, cand=cand,
            frame=np.stack([_to_u8(np.array(f1["left"])),
                            _to_u8(np.array(f1["right"]))]))
        st["packed"] = n(fe._run_step(host(f1, 1), cand).packed)
        streams.append(st)
    # the port's batched inputs
    tb = dict(
        frames=torch.as_tensor(np.stack([s["frame"] for s in streams])),
        dense=stack_streams([interop.dense_state(*s["dense"]) for s in streams]),
        R=torch.as_tensor(np.stack([s["R"] for s in streams])),
        t=torch.as_tensor(np.stack([s["t"] for s in streams])),
        ak=[s["ak"] for s in streams],
        poses=stack_streams([interop.pose_table(*s["poses"]) for s in streams]),
        points=stack_streams([interop.point_table(*s["points"])
                              for s in streams]),
        cand=torch.as_tensor(np.stack([s["cand"] for s in streams]).astype(np.int32)),
    )
    return streams, tb


def _cams():
    cams = [T_CAM.scale_level(l) for l in range(3)]
    return (tuple((c.focal, c.pp[0], c.pp[1], c.baseline) for c in cams),
            tuple(c.size for c in cams))


def _run(tb, stereo):
    cam_params, cam_statics = _cams()
    step = build_multistream_frontend(
        None, cam_params, cam_statics, levels=3, num_disp=64,
        max_reproj=2.0, dense_subs=DENSE_SUBS_BATCHED, dense_sample="qpack",
        stereo=stereo)
    return step(tb["frames"], *tb["dense"], tb["R"], tb["t"], tb["ak"],
                tb["poses"], tb["points"], tb["cand"])


def test_twin_route_matches_jax_per_stream(batch):
    # the CPU default route: each stream's packed vector is JAX's
    # frontend_step (method 1, batched density, exact sampler) from the
    # same state. Bar: 2e-4 absolute plus 1e-6 relative. The reference
    # itself moves 8.9e-5 between two XLA optimization levels on stream 1
    # (its motion-only BA is weakly constrained in t_y there; stream 0:
    # 1.5e-5), so the bar is twice its own spread; the observations are
    # pixel coordinates of 100-250 px whose sub-pixel refinement follows the
    # dense LM's pose, summed over ~27k terms in another order. Measured:
    # within 1.1e-4 (t_y of stream 1) at this suite's XLA level.
    streams, tb = batch
    before = stereo_bm.block_matching_disparity_bm_batched.launches
    out = _run(tb, None)
    assert stereo_bm.block_matching_disparity_bm_batched.launches == before
    assert out.packed.shape == (B, streams[0]["packed"].shape[0])
    assert len(out.clouds) == 3 and out.clouds[0].shape[0] == B
    for s in range(B):
        pj = streams[s]["packed"]
        assert pj[24] > 100 and pj[25] > 100  # a real tracking problem
        np.testing.assert_allclose(out.packed[s].numpy(), pj, atol=2e-4,
                                   rtol=1e-6)


def test_kernel_route_matches_single_stream_method2(batch):
    # on the CPU the kernel route runs the batched kernel's plain version on
    # the binomial-smoothed frames; each stream is then the port's own
    # single-stream step at stereo method 2: R_cw and t_cw within 1e-6,
    # the packed vector within the batched step's bar, 2e-4 plus 1e-6
    # relative (the vmapped program rounds differently; measured: packed
    # 1.9e-5, one f32 ulp of a 146 px coordinate, R_cw 3.0e-8, t_cw
    # 2.0e-7)
    _, tb = batch
    cam_params, cam_statics = _cams()
    out = _run(tb, "kernel")
    clouds, intens, valids, Js = tb["dense"]
    for s in range(B):
        ref = frontend_step(
            tb["frames"][s], *(tuple(x[s] for x in part) for part in
                               (clouds, intens, valids, Js)),
            tb["R"][s], tb["t"][s], tb["ak"][s],
            type(tb["poses"])(*(x[s] for x in tb["poses"])),
            type(tb["points"])(*(x[s] for x in tb["points"])),
            tb["cand"][s], cam_params, cam_statics, 3, 64, False, 2.0, 2,
            dense_subs=DENSE_SUBS_BATCHED)
        assert torch.equal(out.disp[s], ref.disp)
        np.testing.assert_allclose(out.packed[s].numpy(), ref.packed.numpy(),
                                   atol=2e-4, rtol=1e-6)
        assert float(torch.abs(out.R_cw[s] - ref.R_cw).max()) <= 1e-6
        assert float(torch.abs(out.t_cw[s] - ref.t_cw).max()) <= 1e-6
        assert ref.packed[24] > 100


def test_mesh_and_bad_route_raise():
    """A bad stereo route raises; so does a mesh whose dp does not divide
    the streams (the twin's ValueError in StreamPool, and the split of a
    step's stream axis)."""
    cam_params, cam_statics = _cams()
    with pytest.raises(ValueError, match="stereo"):
        build_multistream_frontend(None, cam_params, cam_statics,
                                   stereo="bp")
    mesh = make_mesh(2, dp=2, devices=[CPU] * 2)
    with pytest.raises(ValueError, match="not divisible by mesh dp=2"):
        StreamPool(T_CAM, n_streams=3, mesh=mesh)
    p = _problem(B=3, N=8)
    step = build_multistream_step(mesh, CAM_PARAMS)
    with pytest.raises(ValueError, match="does not split"):
        step(*(torch.as_tensor(p[k]) for k in
               ("R", "t", "xyz", "obs", "w", "v")))


def test_kernel_route_over_a_dp_mesh(batch, monkeypatch):
    """build_multistream_frontend over a dp = 2 mesh of CPU devices: one
    batched block-matching call per shard (one stream each), the same
    disparity and next dense state as the unsharded step's, and the packed
    vector within its bar."""
    from scavislam_tpu_torch.parallel import multistream

    _, tb = batch
    calls = []
    bm = multistream.block_matching_disparity_bm_batched

    def counted(left, right, **kw):
        calls.append(left.shape[0])
        return bm(left, right, **kw)

    cam_params, cam_statics = _cams()
    ref = _run(tb, "kernel")
    step = build_multistream_frontend(
        make_mesh(2, dp=2, devices=[CPU] * 2), cam_params, cam_statics,
        levels=3, num_disp=64, max_reproj=2.0, dense_subs=DENSE_SUBS_BATCHED,
        dense_sample="qpack", stereo="kernel")
    monkeypatch.setattr(multistream, "block_matching_disparity_bm_batched",
                        counted)
    out = step(tb["frames"], *tb["dense"], tb["R"], tb["t"], tb["ak"],
               tb["poses"], tb["points"], tb["cand"])
    assert calls == [1, 1]
    assert torch.equal(out.disp, ref.disp)
    # one program over B = 1 streams per shard against one over B = 2:
    # the vmapped programs round differently (measured: packed 5.9e-5,
    # t_cw 7.2e-6), held to the batched step's packed bar
    np.testing.assert_allclose(out.packed.numpy(), ref.packed.numpy(),
                               atol=2e-4, rtol=1e-6)
    assert torch.equal(out.clouds[0], ref.clouds[0])


def one_ulp(x, gen):
    """`x` with each element moved by -1, 0 or +1 f32 ulp at random."""
    step = torch.randint(-1, 2, x.shape, generator=gen).to(x.device)
    up = torch.nextafter(x, torch.full_like(x, float("inf")))
    down = torch.nextafter(x, torch.full_like(x, float("-inf")))
    return torch.where(step > 0, up, torch.where(step < 0, down, x))


def rounding_spread(single, args, state, leaves, draws=WITNESS_DRAWS):
    """The single-stream step's own sensitivity to rounding on a state:
    the largest move of each leaf of ``leaves(single(*args))`` over
    `draws` calls with every f32 tensor of ``args[i]``, i in `state`,
    moved by at most one ulp. A lane of a batched program departs from
    ``single`` by rounding only if it moves no further than this."""
    gen = torch.Generator().manual_seed(0)
    base = leaves(single(*args))
    worst = dict.fromkeys(base, 0.0)
    for _ in range(draws):
        moved = list(args)
        for i in state:
            moved[i] = pytree.tree_map(
                lambda x: one_ulp(x, gen) if isinstance(x, torch.Tensor)
                and x.dtype == torch.float32 else x, args[i])
        got = leaves(single(*moved))
        for k in base:
            worst[k] = max(worst[k], float(torch.abs(got[k] - base[k]).max()))
    return worst


def mono_leaves(out):
    """The leaves a lane of the batched mono step is held on: the packed
    head (pose, counts, gates, observations), the packed post-update
    information, psi and Lambda."""
    head = 34 + 4 * out.gate.shape[-1]
    return {"head": out.packed[:head], "info": out.packed[head:],
            "psi": out.points.psi, "Lam": out.Lam}


def mono_bars(args, cam_params, cam_statics):
    """Each mono leaf's bar on one stream's state (mono_step's arguments
    `args`): MONO_BAR, or WITNESS_MARGIN times the single-stream step's
    own move under one-ulp state moves where that is larger."""
    spread = rounding_spread(
        lambda *a: mono_step(*a, cam_params, cam_statics, 3, 2.0, 0.18),
        args, MONO_STATE, mono_leaves)
    return {k: max(MONO_BAR, WITNESS_MARGIN * v) for k, v in spread.items()}


def hold_mono(lane, ref, bars):
    """A lane of a batched mono step against the step `ref`: the same
    gates, each leaf within its bar."""
    assert torch.equal(lane.gate, ref.gate)
    got, want = mono_leaves(lane), mono_leaves(ref)
    for k, bar in bars.items():
        d = float(torch.abs(got[k] - want[k]).max())
        assert d <= bar, (k, d, bar)


def test_multistream_mono_matches_per_stream():
    """build_multistream_mono against per-stream mono_step calls, as
    tests/test_parallel.py's TestMultistreamMono holds the twin: stream
    state from short real mono runs (different step sizes), so the check
    covers populated point/Lambda tables and live candidate sections. Each
    lane within `mono_bars` of the per-stream call: the batched program
    rounds differently, and the mono LM and depth filter amplify that as
    they amplify a one-ulp move of the step's state
    (tests/test_torch_multistream_vmap.py)."""
    from scavislam_tpu_torch.io.synthetic import (
        SyntheticSequence as TSeq,
    )
    from scavislam_tpu_torch.models.mono_frontend import MonoFrontend
    from scavislam_tpu_torch.parallel.multistream import (
        build_multistream_mono,
    )

    cam = interop.camera(130.0, (63.5, 47.5), (128, 96), 0.12)
    fes, imgs = [], []
    for s in range(B):
        seq = TSeq(cam, n_frames=3, kind="forward_arc", step=0.03 + 0.01 * s,
                   device=CPU)
        fe = MonoFrontend(cam, device=CPU)
        fe.process_first_frame(seq.frame(0))
        ok, _ = fe.process_frame(seq.frame(1))
        assert ok
        fes.append(fe)
        imgs.append(seq.frame(2)["left"])
    cands = [torch.as_tensor(fe._collect_candidates().astype(np.int32))
             for fe in fes]
    step = build_multistream_mono(None, fes[0]._cam_params,
                                  fes[0]._cam_statics, levels=3)
    out = step(
        torch.stack(imgs),
        torch.stack([torch.as_tensor(fe._R_cw) for fe in fes]),
        torch.stack([torch.as_tensor(fe._t_cw) for fe in fes]),
        torch.tensor([max(fe.actkey_id, 0) for fe in fes]),
        stack_streams([fe.poses for fe in fes]),
        stack_streams([fe.points for fe in fes]),
        torch.stack([fe.Lam for fe in fes]), torch.stack(cands),
        torch.full((B,), fes[0].conv_q_info),
        torch.full((B,), fes[0].prior_weight))
    assert out.packed.shape[0] == B and out.Lam.shape[0] == B
    bars = []
    for s, fe in enumerate(fes):
        args = (imgs[s], torch.as_tensor(fe._R_cw), torch.as_tensor(fe._t_cw),
                max(fe.actkey_id, 0), fe.poses, fe.points, fe.Lam, cands[s],
                fe.conv_q_info, fe.prior_weight)
        ref = mono_step(*args, fe._cam_params, fe._cam_statics, 3, 2.0, 0.18)
        assert ref.packed[25] >= 15  # the frame tracks
        bars.append(mono_bars(args, fe._cam_params, fe._cam_statics))
        hold_mono(stream_slice(out, s), ref, bars[s])
    # over a dp = 2 mesh of CPU devices: one stream per shard, each within
    # the same bars of the unsharded step's lane
    step_m = build_multistream_mono(make_mesh(2, dp=2, devices=[CPU] * 2),
                                    fes[0]._cam_params, fes[0]._cam_statics,
                                    levels=3)
    out_m = step_m(
        torch.stack(imgs),
        torch.stack([torch.as_tensor(fe._R_cw) for fe in fes]),
        torch.stack([torch.as_tensor(fe._t_cw) for fe in fes]),
        torch.tensor([max(fe.actkey_id, 0) for fe in fes]),
        stack_streams([fe.poses for fe in fes]),
        stack_streams([fe.points for fe in fes]),
        torch.stack([fe.Lam for fe in fes]), torch.stack(cands),
        torch.full((B,), fes[0].conv_q_info),
        torch.full((B,), fes[0].prior_weight))
    for s in range(B):
        hold_mono(stream_slice(out_m, s), stream_slice(out, s), bars[s])

"""Belief-propagation stereo (stereo methods 3 and 4) in the port against
the JAX package, on the CPU: tests/test_ops_stereo_bp.py's cases on the
port, op-level parity on the same seeded pair, the helpers on odd sizes,
and the frame step and StereoFrontend with each method selected.

The twin's shapes and static arguments (_BP_ARGS, _CSBP_ARGS, 96x128) are
reused so that each of its XLA programs compiles once.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scavislam_tpu.core.camera import StereoCamera as JCam
from scavislam_tpu.io.synthetic import SyntheticSequence as JSequence
from scavislam_tpu.io.synthetic import closed_box
from scavislam_tpu.models.frontend import StereoFrontend as JFrontend
from scavislam_tpu.ops import stereo_bp as jbp
from scavislam_tpu.utils.config import Config as JConfig
from scavislam_tpu_torch import interop
from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.io.synthetic import SyntheticSequence
from scavislam_tpu_torch.models.frontend import StereoFrontend, _to_u8
from scavislam_tpu_torch.models.frontend_step import normalize_frames
from scavislam_tpu_torch.ops import stereo_bm
from scavislam_tpu_torch.ops import stereo_bp as tbp
from scavislam_tpu_torch.ops.image import binomial3
from scavislam_tpu_torch.utils.config import Config
from test_ops_stereo_bp import _BP_ARGS, _CSBP_ARGS, make_pair

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return make_pair()


@pytest.fixture(scope="module")
def jax_out(pair):
    left, right = (jnp.asarray(x) for x in pair[:2])
    return {"bp": np.asarray(jbp.belief_propagation_disparity(
                left, right, **_BP_ARGS)),
            "csbp": np.asarray(jbp.constant_space_bp_disparity(
                left, right, **_CSBP_ARGS))}


@pytest.fixture(scope="module")
def port_out(pair):
    left, right = (torch.as_tensor(x) for x in pair[:2])
    return {"bp": tbp.belief_propagation_disparity(
                left, right, **_BP_ARGS).numpy(),
            "csbp": tbp.constant_space_bp_disparity(
                left, right, **_CSBP_ARGS).numpy()}


# -- tests/test_ops_stereo_bp.py's bars, on the port ---------------------------

class TestBeliefPropagation:
    def test_recovers_piecewise_disparity(self, pair, port_out):
        _, _, d_gt, interior = pair
        err = np.abs(port_out["bp"] - d_gt)[interior]
        assert (err <= 1.0).mean() > 0.97, f"only {(err<=1).mean():.2f} <=1px"
        assert err.mean() < 0.3

    def test_dense_output(self, pair, port_out):
        disp = port_out["bp"]
        assert disp.shape == pair[0].shape and disp.dtype == np.float32
        assert np.isfinite(disp).all()
        assert disp.min() >= 0.0 and disp.max() <= _BP_ARGS["num_disp"]


class TestConstantSpaceBP:
    def test_recovers_piecewise_disparity(self, pair, port_out):
        _, _, d_gt, interior = pair
        err = np.abs(port_out["csbp"] - d_gt)[interior]
        assert (err <= 1.0).mean() > 0.9, f"only {(err<=1).mean():.2f} <=1px"

    def test_odd_disparities_reachable(self, pair, port_out):
        # the per-level candidate expansion reaches odd disparities
        _, _, d_gt, interior = pair
        frac = (np.abs(port_out["csbp"] - 5.0) < 0.5)[
            interior & (d_gt == 5)].mean()
        assert frac > 0.8


# -- parity with the twin --------------------------------------------------------

def test_bp_matches_jax(jax_out, port_out):
    # the closed-form distance transform rounds differently from the twin's
    # recurrence (a few ulps of the messages): |delta| <= 1e-3 px on >= 99%
    # of pixels and <= 1 px on all (measured: 99.98% within 1e-3, the
    # largest 0.5 px, one near-tie of two disparities)
    d = np.abs(port_out["bp"] - jax_out["bp"])
    assert (d <= 1e-3).mean() >= 0.99, (d <= 1e-3).mean()
    assert d.max() <= 1.0, d.max()


def test_csbp_matches_jax(jax_out, port_out):
    # whole-pixel output, equal on >= 99% of pixels (measured: 100%; the
    # coarsest level's BP runs the twin's recurrence: with the closed form
    # there, 97.2%)
    eq = (port_out["csbp"] == jax_out["csbp"]).mean()
    assert eq >= 0.99, eq


@pytest.mark.parametrize("recurrence", [False, True])
def test_distance_transform_matches_jax(recurrence):
    # D = 64 with BP's constants on inputs of 0..30: the recurrence is the
    # twin's, bit for bit; the closed form within 1e-5 (measured 5.0e-6)
    rng = np.random.default_rng(64)
    h = (rng.random((64, 12, 16)) * 30.0).astype(np.float32)
    mj = np.asarray(jbp._dt_truncated_linear(jnp.asarray(h), 1.0, 1.7))
    mt = tbp._dt_truncated_linear(torch.as_tensor(h), 1.0, 1.7,
                                  recurrence).numpy()
    if recurrence:
        np.testing.assert_array_equal(mt, mj)
    else:
        np.testing.assert_allclose(mt, mj, atol=1e-5)


def test_helpers_match_jax_on_odd_sizes():
    # sum-pool with padding, 2x upsample with crop, the four shifts, the
    # candidate gather, on a (3, 7, 9) volume: elementwise, so bit for bit
    rng = np.random.default_rng(1)
    x = rng.random((3, 7, 9)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.as_tensor(x)
    np.testing.assert_array_equal(tbp._sum_pool2(xt).numpy(),
                                  np.asarray(jbp._sum_pool2(xj)))
    np.testing.assert_array_equal(tbp._upsample2(xt, 13, 17).numpy(),
                                  np.asarray(jbp._upsample2(xj, 13, 17)))
    for dy, dx in tbp._DIRS:
        np.testing.assert_array_equal(tbp._shift2d(xt, dy, dx).numpy(),
                                      np.asarray(jbp._shift2d(xj, dy, dx)))
    left, right = x[0], x[1]
    cand = rng.integers(0, 12, size=(4, 7, 9))
    np.testing.assert_array_equal(
        tbp._candidate_data_cost(torch.as_tensor(left), torch.as_tensor(right),
                                 torch.as_tensor(cand)).numpy(),
        np.asarray(jbp._candidate_data_cost(jnp.asarray(left),
                                            jnp.asarray(right),
                                            jnp.asarray(cand, jnp.int32))))


# -- the frame step and the frontend with the method selected --------------------

def _position(T):
    """Camera position -R^T t of a pose (either package), float64."""
    R, t = np.asarray(T.R, np.float64), np.asarray(T.t, np.float64)
    return -R.T @ t


def _cfg(cls, method, opts=(3, 3, 4)):
    cfg = cls()
    return dataclasses.replace(cfg, ui=dataclasses.replace(
        cfg.ui, stereo_method=method, stereo_iters=opts[0],
        stereo_levels=opts[1], stereo_nr_plane=opts[2]))


@pytest.mark.parametrize("method", [3, 4])
def test_frontend_step_runs_with_method(method):
    # 64x96: the frame step's disparity is the selected method's on the
    # prefiltered pair with the frontend's stereo_opts (BP raised to the
    # twin's floor of 5 iterations and 4 levels), no block-matching call,
    # and the step's packed output finite with matches
    cam = StereoCamera.create(48.0, (47.5, 31.5), (96, 64), 0.1)
    seq = SyntheticSequence(cam, n_frames=2, step=0.02, device=CPU)
    f0, f1 = seq.frame(0), seq.frame(1)
    fe = StereoFrontend(cam, _cfg(Config, method), device=CPU)
    before = stereo_bm.block_matching_disparity_bm.launches
    fe.process_first_frame(f0)
    out = fe._run_step(f1, fe._collect_candidates())
    # the step takes the frames as bytes
    left, right = (binomial3(normalize_frames(_to_u8(f1[k])))
                   for k in ("left", "right"))
    if method == 3:
        ref = tbp.belief_propagation_disparity(left, right, num_disp=64,
                                               iters=5, levels=4)
    else:
        ref = tbp.constant_space_bp_disparity(left, right, num_disp=64,
                                              iters=3, levels=3, nr_plane=4)
    assert torch.equal(out.disp, ref)
    assert stereo_bm.block_matching_disparity_bm.launches == before
    assert torch.isfinite(out.packed).all()
    assert out.packed[24] > 0  # matches


@pytest.mark.slow
@pytest.mark.parametrize("method", [3, 4])
def test_frontend_parity_with_method(method):
    # tests/test_ops_stereo_bp.py's 4-frame run at 256x192 (iters 3,
    # levels 3, nr_plane 4) on the twin's frames through both frontends:
    # every frame tracked, the twin's bar (< 0.05 m from ground truth), and
    # the port's camera positions within 1 mm of the twin's
    jcam = JCam.create(195.0, (127.0, 95.0), (256, 192), 0.12)
    tcam = interop.camera(np.asarray(jcam.focal), np.asarray(jcam.pp),
                          jcam.size, np.asarray(jcam.baseline))
    seq = JSequence(jcam, n_frames=4, step=0.02)
    frames = []
    for i in range(4):
        f = seq.frame(i)
        frames.append({"frame_id": i, "left": np.array(f["left"]),
                       "right": np.array(f["right"]), "gt": f["T_cw_gt"]})
    fj = JFrontend(jcam, _cfg(JConfig, method))
    ft = StereoFrontend(tcam, _cfg(Config, method), device=CPU)
    for fe in (fj, ft):
        fe.process_first_frame({k: frames[0][k] for k in
                                ("frame_id", "left", "right")})
    for f in frames[1:]:
        host = {k: f[k] for k in ("frame_id", "left", "right")}
        ok_j, _ = fj.process_frame(host)
        ok_t, _ = ft.process_frame(dict(host))
        assert ok_j and ok_t, f"method {method}: frame {f['frame_id']}"
        pos = [_position(fj._world_pose()), _position(ft._world_pose())]
        assert np.linalg.norm(pos[1] - _position(f["gt"])) < 0.05
        assert np.linalg.norm(pos[1] - pos[0]) < 1e-3, (pos, method)


@pytest.mark.slow
def test_csbp_wander_matches_jax():
    # constant-space BP's whole-pixel disparities cost tracking accuracy on
    # the 40-frame wander in the closed box (step 0.06) at 256x192, in the
    # JAX package as in the port: measured ATE 0.1907 m on both (the block
    # matcher: 0.012 m), camera positions within 0.18 mm of each other.
    # Required: every frame tracked, positions within 1 mm, ATE within 1%
    jcam = JCam.create(195.0, (127.0, 95.0), (256, 192),
                       JConfig().cam.baseline)
    tcam = interop.camera(np.asarray(jcam.focal), np.asarray(jcam.pp),
                          jcam.size, np.asarray(jcam.baseline))
    seq = JSequence(jcam, n_frames=40, kind="wander", planes=closed_box(),
                    step=0.06)
    frames = [{"frame_id": i, "left": np.array(f["left"]),
               "right": np.array(f["right"]), "T": f["T_cw_gt"]}
              for i, f in ((i, seq.frame(i)) for i in range(40))]
    runs = []
    for fe in (JFrontend(jcam, _cfg(JConfig, 4, (4, 4, 4))),
               StereoFrontend(tcam, _cfg(Config, 4, (4, 4, 4)), device=CPU)):
        fe.process_first_frame({k: frames[0][k] for k in
                                ("frame_id", "left", "right")})
        pos, err = [_position(fe._world_pose())], []
        for f in frames[1:]:
            ok, _ = fe.process_frame({k: f[k] for k in
                                      ("frame_id", "left", "right")})
            assert ok, f"frame {f['frame_id']}"
            pos.append(_position(fe._world_pose()))
        for p, f in zip(pos, frames):
            err.append(p - _position(f["T"]))
        runs.append((np.stack(pos), float(np.sqrt(
            (np.stack(err) ** 2).sum(1).mean()))))
    (pj, ate_j), (pt, ate_t) = runs
    assert np.linalg.norm(pt - pj, axis=1).max() < 1e-3
    assert abs(ate_t - ate_j) <= 0.01 * ate_j, (ate_t, ate_j)

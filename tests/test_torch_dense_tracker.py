"""The port's forward-compositional dense tracker and its point-cloud helpers
against the JAX package's (tests/test_dense_tracker.py's five cases), on the
same rendered frames, on the CPU.

The twin's bf16 matrix-unit sampler and its tap packing are TPU workarounds
the port does not carry, so test_dense_tracker.py's two sampler cases have
no counterpart here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scavislam_tpu.core.camera import StereoCamera as JCam
from scavislam_tpu.core.lie import SE3 as JSE3
from scavislam_tpu.io.synthetic import SyntheticSequence
from scavislam_tpu.models import dense_tracker as jdt
from scavislam_tpu.ops.image import preprocess_frame as jpre
from scavislam_tpu_torch.core.camera import StereoCamera as TCam
from scavislam_tpu_torch.core.lie import SE3
from scavislam_tpu_torch.models import dense_tracker as tdt
from scavislam_tpu_torch.ops.image import preprocess_frame as tpre

J_CAM = JCam.create(195.0, (127.0, 95.0), (256, 192), 0.12)
T_CAM = TCam.create(195.0, (127.0, 95.0), (256, 192), 0.12)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    """Frames 0 and 1 of the twin's forward arc, numpy."""
    seq = SyntheticSequence(J_CAM, n_frames=4, kind="forward_arc")
    out = []
    for i in range(2):
        f = seq.frame(i)
        out.append({"left": np.array(f["left"]),
                    "disp_gt": np.array(f["disp_gt"]),
                    "R": np.asarray(f["T_cw_gt"].R),
                    "t": np.asarray(f["T_cw_gt"].t)})
    return out


def _jax_inputs(f, T):
    clouds, valids = jdt.cloud_pyramid_from_disparity(
        jnp.asarray(f["disp_gt"]), J_CAM, T, 3)
    pre = jpre(jnp.asarray(f["left"]), 3)
    return clouds, tuple(p.reshape(-1) for p in pre["pyr"]), valids


def _port_inputs(f, T):
    clouds, valids = tdt.cloud_pyramid_from_disparity(
        torch.as_tensor(f["disp_gt"]), T_CAM, T, 3)
    pre = tpre(torch.as_tensor(f["left"]), 3)
    return clouds, tuple(p.reshape(-1) for p in pre["pyr"]), valids


def _track_both(f_ref, f_cur):
    """dense_tracking from the identity on both packages, reference cloud
    from f_ref's exact disparity, current image f_cur."""
    cj = _jax_inputs(f_ref, JSE3.identity())
    ct = _port_inputs(f_ref, SE3.identity())
    # clouds within an ulp or two (XLA fuses the back-projection's
    # divisions and products in another order), the same valid masks
    for a, b in zip(cj[0], ct[0]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    for a, b in zip(cj[2], ct[2]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    rj = jdt.dense_tracking(jpre(jnp.asarray(f_cur["left"]), 3), *cj,
                            [J_CAM.scale_level(l) for l in range(3)],
                            JSE3.identity())
    rt = tdt.dense_tracking(tpre(torch.as_tensor(f_cur["left"]), 3), *ct,
                            [T_CAM.scale_level(l) for l in range(3)],
                            SE3.identity())
    return rj, rt


@pytest.fixture(scope="module")
def tracked(frames):
    return {"same": _track_both(frames[0], frames[0]),
            "motion": _track_both(frames[0], frames[1])}


def test_identity_when_same_frame(tracked):
    # the twin's bar (log within 1e-3 of zero) on the port, and within 1e-5
    # of the twin's pose (measured 5.5e-9, 1.9e-8 m). The accepted steps
    # are not compared here: at the identity a candidate step is of the
    # size of the rounding, and taking it compares two chi2 sums equal to
    # within their summation order (measured: the twin takes one more step
    # at the coarsest level than the port)
    rj, rt = tracked["same"]
    np.testing.assert_allclose(rt.T.log().numpy(), np.zeros(6), atol=1e-3)
    np.testing.assert_allclose(rt.T.R.numpy(), np.asarray(rj.T.R), atol=1e-5)
    np.testing.assert_allclose(rt.T.t.numpy(), np.asarray(rj.T.t), atol=1e-5)


def test_recovers_interframe_motion(tracked, frames):
    # the twin's bar: mm-level recovery of the ~6 cm GT motion; and the
    # port's pose within 2e-5 of the twin's (f32 LMs whose normal equations
    # sum ~10^4 terms in another order; measured 1.3e-7 rotation, 4.9e-7 m)
    # with the same accepted steps per level
    rj, rt = tracked["motion"]
    Rg = frames[1]["R"] @ frames[0]["R"].T
    tg = frames[1]["t"] - Rg @ frames[0]["t"]
    T_gt = SE3(torch.as_tensor(Rg), torch.as_tensor(tg))
    err = (rt.T @ T_gt.inverse()).log()
    assert float(torch.max(torch.abs(err))) < 5e-3, err
    np.testing.assert_allclose(rt.T.R.numpy(), np.asarray(rj.T.R), atol=2e-5)
    np.testing.assert_allclose(rt.T.t.numpy(), np.asarray(rj.T.t), atol=2e-5)
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))


def test_chi2_decreases(tracked, frames):
    # finite chi2 at every level, within 5e-4 relative of the twin's
    # (measured 1.2e-6 at level 0, 1.6e-4 at the coarsest level)
    rj, rt = tracked["motion"]
    assert np.isfinite(rt.chi2.numpy()).all()
    np.testing.assert_allclose(rt.chi2.numpy(), np.asarray(rj.chi2),
                               rtol=5e-4)
    # the residual at the solution beats the identity pose's
    ct = _port_inputs(frames[0], SE3.identity())
    cur = tpre(torch.as_tensor(frames[1]["left"]), 3)
    eye = SE3.identity()
    chi2_id = tdt._chi2(T_CAM, cur["pyr"][0], eye.R, eye.t, ct[0][0],
                        ct[1][0], ct[2][0])
    assert float(rt.chi2[0]) < float(chi2_id)


def test_backprojection_roundtrip(frames):
    # the twin's check (reprojected onto the stride-4 grid within 0.05 px),
    # and the cloud equal to the twin's within 1e-5 relative
    d = frames[0]["disp_gt"]
    xyz, valid = tdt.compute_dense_point_cloud(torch.as_tensor(d), T_CAM,
                                               SE3.identity(), stride=4)
    xj, vj = jdt.compute_dense_point_cloud(jnp.asarray(d), J_CAM,
                                           JSE3.identity(), stride=4)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(vj))
    np.testing.assert_allclose(xyz.numpy(), np.asarray(xj), rtol=1e-5,
                               atol=1e-6)
    sel = np.flatnonzero(valid.numpy())[:100]
    uvu = T_CAM.map_uvu(xyz[sel])
    w = d.shape[1]
    np.testing.assert_allclose(uvu[:, 0].numpy(), (sel % (w // 4)) * 4,
                               atol=0.05)
    np.testing.assert_allclose(uvu[:, 1].numpy(), (sel // (w // 4)) * 4,
                               atol=0.05)


def test_cloud_in_actkey_frame(frames):
    # T applied to the actkey-frame cloud gives the camera-frame cloud
    # (1e-4, the twin's bar); the actkey cloud within 1e-5 of the twin's
    d = frames[1]["disp_gt"]
    xi = np.array([0.05, 0.0, 0.02, 0.0, 0.01, 0.0], np.float32)
    T = SE3.exp(torch.as_tensor(xi))
    xyz_ak, _ = tdt.compute_dense_point_cloud(torch.as_tensor(d), T_CAM, T,
                                              stride=8)
    xyz_cam, _ = tdt.compute_dense_point_cloud(torch.as_tensor(d), T_CAM,
                                               SE3.identity(), stride=8)
    np.testing.assert_allclose(T.apply(xyz_ak).numpy(), xyz_cam.numpy(),
                               atol=1e-4)
    xj, _ = jdt.compute_dense_point_cloud(jnp.asarray(d), J_CAM,
                                          JSE3.exp(jnp.asarray(xi)), stride=8)
    np.testing.assert_allclose(xyz_ak.numpy(), np.asarray(xj), rtol=1e-5,
                               atol=1e-5)

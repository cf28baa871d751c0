"""The host shell both frame-step frontends share
(models/host_frontend.py) and the host readers of the two frame steps'
packed downloads, on the CPU: each reader's fields against the tensors
the step returned or the state it was handed, the keyframe table's
overflow in both frontends, and the stacking of in-flight corrections.

Frames: the port's renderer at the twin's 128x96 test camera."""

import numpy as np
import pytest
import torch

from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.io.synthetic import SyntheticSequence
from scavislam_tpu_torch.models.frontend import StereoFrontend
from scavislam_tpu_torch.models.frontend_step import PackedStep
from scavislam_tpu_torch.models.host_frontend import InFlight
from scavislam_tpu_torch.models.map_store import MAX_KEYFRAMES
from scavislam_tpu_torch.models.mono_frontend import MonoFrontend
from scavislam_tpu_torch.models.mono_step import PackedMonoStep, mono_step

CPU = torch.device("cpu")
CAM = StereoCamera.create(130.0, (63.5, 47.5), (128, 96), 0.12)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_stereo_reader_fields_are_the_step_outputs():
    seq = SyntheticSequence(CAM, n_frames=2, step=0.03, device=CPU)
    fe = StereoFrontend(CAM, device=CPU)
    fe.process_first_frame(seq.frame(0))
    out = fe._run_step(seq.frame(1), fe._collect_candidates())
    pk = PackedStep.read(out.packed.numpy())
    for name, want in (("R_cw", out.R_cw), ("t_cw", out.t_cw),
                       ("R_cak", out.R_cak), ("t_cak", out.t_cak),
                       ("n_matched", out.n_matched),
                       ("n_gated", out.n_gated), ("t_norm", out.t_norm),
                       ("mean_track_len", out.mean_track_len),
                       ("quad_counts", out.quad_counts),
                       ("gate", out.gate), ("obs", out.obs_uvu)):
        np.testing.assert_array_equal(getattr(pk, name),
                                      want.numpy().astype(np.float32)
                                      if name != "gate" else want.numpy(),
                                      err_msg=name)
    assert pk.gate.dtype == bool and 0 < pk.gate.sum() < len(pk.gate)


def test_mono_reader_fields_are_the_step_outputs():
    seq = SyntheticSequence(CAM, n_frames=2, kind="forward_arc", step=0.035,
                            device=CPU)
    fe = MonoFrontend(CAM, device=CPU)
    fe.process_first_frame(seq.frame(0))
    cand = fe._cand_device(fe._collect_candidates())
    R, t = fe._pose_dev()
    ak = fe._actkey_dev()
    poses, points, Lam = fe.poses, fe.points, fe.Lam
    out = mono_step(seq.frame(1)["left"], R, t, ak, poses, points, Lam, cand,
                    fe._conv_dev, fe._pw_dev, fe._cam_params,
                    fe._cam_statics, fe.levels)
    pk = PackedMonoStep.read(out.packed.numpy())
    C = len(cand)
    gate = out.gate
    assert pk.gate.dtype == bool and 0 < int(gate.sum()) < C
    np.testing.assert_array_equal(pk.R_cw, out.R_cw.numpy())
    np.testing.assert_array_equal(pk.t_cw, out.t_cw.numpy())
    np.testing.assert_array_equal(pk.gate, gate.numpy())
    np.testing.assert_array_equal(pk.obs_uv, out.obs_uv.numpy())
    # the counts: the matched flags further down the vector, the gate, and
    # the gated candidates whose information was past the convergence bar
    # when the step was handed it
    safe = cand.clamp(0, len(Lam) - 1).long()
    assert pk.n_matched == float((out.packed[34 + C:34 + 2 * C] > 0.5).sum())
    assert pk.n_gated == float(gate.sum())
    assert pk.n_conv == float((gate & (Lam[safe][:, 2, 2]
                                       > fe.conv_q_info)).sum())
    # |t_cur_from_actkey| and the mean track length of the actkey's points
    R_ak, t_ak = poses.R[int(ak)], poses.t[int(ak)]
    t_cak = out.t_cw - (out.R_cw @ R_ak.T) @ t_ak
    np.testing.assert_allclose(pk.t_norm, float(torch.linalg.norm(t_cak)),
                               rtol=1e-6)
    own = gate & (points.anchor[safe] == int(ak))
    track = torch.linalg.norm(out.obs_uv - points.uv0[safe], dim=-1)
    np.testing.assert_allclose(
        pk.mean_track_len, float(track[own].sum() / max(int(own.sum()), 1)),
        rtol=1e-6)
    w, h = CAM.size
    quad = ((out.obs_uv[:, 1] > h / 2).long() * 2
            + (out.obs_uv[:, 0] > w / 2).long())
    np.testing.assert_array_equal(
        pk.quad_counts, np.bincount(quad[gate].numpy(), minlength=4))
    # the gated rows' information after the filter update
    np.testing.assert_array_equal(pk.lam_qq[gate.numpy()],
                                  out.Lam[safe][:, 2, 2][gate].numpy())


@pytest.mark.parametrize("make", [
    lambda: StereoFrontend(CAM, device=CPU),
    lambda: MonoFrontend(CAM, device=CPU),
], ids=["stereo", "mono"])
def test_a_full_keyframe_table_raises(make):
    fe = make()
    fe.next_kf = MAX_KEYFRAMES - 1
    assert fe._new_keyframe_id() == MAX_KEYFRAMES - 1
    with pytest.raises(RuntimeError, match="keyframe table full"):
        fe._new_keyframe_id()
    assert fe.next_kf == MAX_KEYFRAMES


def test_stacked_corrections_compose_right():
    # two rebases after a frame's dispatch: its fetched pose right-times
    # the first correction, then the second
    rng = np.random.default_rng(0)

    def rot(w):
        (R, _) = np.linalg.qr(w.reshape(3, 3))
        return (R * np.sign(np.linalg.det(R))).astype(np.float32)

    R, R1, R2 = (rot(rng.normal(size=9)) for _ in range(3))
    t, t1, t2 = (rng.normal(size=3).astype(np.float32) for _ in range(3))
    f = InFlight(7, np.zeros(4, np.int64), None, None, 0, None)
    assert all(a is b for a, b in zip(f.world_pose(R, t), (R, t)))
    g = f.corrected(R1, t1).corrected(R2, t2)
    assert g.frame_id == 7 and f.corr is None
    Rg, tg = g.world_pose(R, t)
    np.testing.assert_allclose(Rg, R @ R1 @ R2, atol=1e-6)
    np.testing.assert_allclose(tg, R @ (R1 @ t2 + t1) + t, atol=1e-5)

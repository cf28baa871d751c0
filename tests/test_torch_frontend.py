"""The stereo-VO slice: the port's frontend step and StereoFrontend against
the JAX package on the same frames, on the CPU.

Both sides run stereo method 1 (the cost-volume twin) for the parity tests:
on the CPU the JAX package runs that twin for methods 1 and 2 alike. The
port's method 2 path (the block-matching kernel's plain version on the CPU)
is held to the JAX VO test's own accuracy bar.
"""

import dataclasses

import numpy as np
import pytest
import torch

from scavislam_tpu.core.camera import StereoCamera as JCam
from scavislam_tpu.io.synthetic import SyntheticSequence
from scavislam_tpu.models.frontend import StereoFrontend as JFrontend
from scavislam_tpu.utils.config import Config as JConfig
from scavislam_tpu_torch import interop
from scavislam_tpu_torch.models.frontend import CAND_CAP
from scavislam_tpu_torch.models.frontend import StereoFrontend as TFrontend
from scavislam_tpu_torch.ops import stereo_bm
from scavislam_tpu_torch.utils.config import Config as TConfig

J_CAM = JCam.create(195.0, (127.0, 95.0), (256, 192), 0.12)
T_CAM = interop.camera(np.asarray(J_CAM.focal), np.asarray(J_CAM.pp),
                       J_CAM.size, np.asarray(J_CAM.baseline))
N_FRAMES = 8
SNAP_FRAME = 4  # the frame whose single step is compared
CPU = torch.device("cpu")


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


def _cfg(cls, method):
    cfg = cls()
    return dataclasses.replace(cfg, ui=dataclasses.replace(cfg.ui, stereo_method=method))


def _position(T):
    R, t = np.asarray(T.R, np.float64), np.asarray(T.t, np.float64)
    return -R.T @ t


def _ate(est, gt):
    errs = [Te.R @ (-Tg_R.T @ Tg_t) + Te.t for Te, (Tg_R, Tg_t) in zip(est, gt)]
    errs = np.stack(errs)
    return float(np.sqrt((errs ** 2).sum(axis=1).mean()))


@pytest.fixture(scope="module")
def frames():
    seq = SyntheticSequence(J_CAM, n_frames=N_FRAMES)
    out = []
    for i in range(N_FRAMES):
        f = seq.frame(i)
        out.append({"frame_id": i, "left": np.array(f["left"]),
                    "right": np.array(f["right"]),
                    "gt": (np.asarray(f["T_cw_gt"].R, np.float64),
                           np.asarray(f["T_cw_gt"].t, np.float64))})
    return out


def _host(f):
    return {"frame_id": f["frame_id"], "left": f["left"], "right": f["right"]}


def _snapshot(fe):
    """The JAX frontend's state as numpy arrays."""
    n = np.asarray
    return dict(
        poses=[n(fe.poses.R), n(fe.poses.t), n(fe.poses.valid)],
        points=[n(x) for x in fe.points],
        dense=[[n(x) for x in fe._prev_clouds], [n(x) for x in fe._prev_intens],
               [n(x) for x in fe._prev_valids], [n(x) for x in fe._prev_J]],
        R_cw=n(fe._dev_R_cw), t_cw=n(fe._dev_t_cw),
        R_cak=n(fe._R_cak), t_cak=n(fe._t_cak), actkey_id=fe.actkey_id,
        next_kf=fe.next_kf, next_point=fe.next_point,
        kf_point_ids=dict(fe.kf_point_ids), covis=dict(fe.covis),
        pose_np=dict(fe.pose_np), meta_anchor=fe._meta_anchor.copy(),
        meta_level=fe._meta_level.copy(), frame_id=fe.frame_id,
    )


@pytest.fixture(scope="module")
def jax_run(frames):
    """JAX StereoFrontend, stereo method 1, over the forward arc. Before
    SNAP_FRAME it records the state and that frame's packed step output."""
    fe = JFrontend(J_CAM, _cfg(JConfig, 1))
    fe.process_first_frame(_host(frames[0]))
    est, drops, snap = [fe._world_pose()], [], None
    for f in frames[1:]:
        if f["frame_id"] == SNAP_FRAME:
            snap = _snapshot(fe)
            chain = (fe._dev_R_cw, fe._dev_t_cw)
            snap["cand_ids"] = fe._collect_candidates()
            out = fe._run_step(_host(f), snap["cand_ids"])
            snap["packed"] = np.asarray(out.packed)
            fe._dev_R_cw, fe._dev_t_cw = chain  # the run goes on unchanged
        ok, dropped = fe.process_frame(_host(f))
        assert ok
        est.append(fe._world_pose())
        if dropped:
            drops.append(f["frame_id"])
    return {"est": est, "drops": drops, "next_kf": fe.next_kf, "snap": snap,
            "ate": _ate(est, [f["gt"] for f in frames])}


def _run_port(frames, method, as_tensors=False):
    fe = TFrontend(T_CAM, _cfg(TConfig, method), device=CPU)
    conv = ((lambda f: {k: torch.as_tensor(v) if k != "frame_id" else v
                        for k, v in _host(f).items()})
            if as_tensors else _host)
    fe.process_first_frame(conv(frames[0]))
    est, drops = [fe._world_pose()], []
    for f in frames[1:]:
        ok, dropped = fe.process_frame(conv(f))
        assert ok, f"tracking failed at frame {f['frame_id']}"
        est.append(fe._world_pose())
        if dropped:
            drops.append(f["frame_id"])
    return fe, est, drops


@pytest.fixture(scope="module")
def port_run(frames):
    return _run_port(frames, 1)


def test_frontend_step_parity(frames, jax_run):
    # One step from the same state (tables, dense state, pose chain, ids),
    # stereo method 1 on both sides. R and t agree to 1e-4 (f32 LMs whose
    # normal equations sum ~10^4 terms in another order); the match counts
    # within 2 and the gate masks on >= 99% of the candidate slots (a
    # borderline ZMSSD or reprojection test can fall either way).
    s = jax_run["snap"]
    fe = TFrontend(T_CAM, _cfg(TConfig, 1), device=CPU)
    interop.load_frontend_state(
        fe, poses=interop.pose_table(*s["poses"]),
        points=interop.point_table(*s["points"]),
        dense=interop.dense_state(*s["dense"]),
        R_cw=s["R_cw"], t_cw=s["t_cw"], R_cak=s["R_cak"], t_cak=s["t_cak"],
        actkey_id=s["actkey_id"], next_kf=s["next_kf"],
        next_point=s["next_point"], kf_point_ids=s["kf_point_ids"],
        covis=s["covis"], pose_np=s["pose_np"], meta_anchor=s["meta_anchor"],
        meta_level=s["meta_level"], frame_id=s["frame_id"])
    cand = fe._collect_candidates()
    np.testing.assert_array_equal(cand, s["cand_ids"])
    pt = fe._run_step(_host(frames[SNAP_FRAME]), cand).packed.numpy()
    pj = s["packed"]
    assert pt.shape == pj.shape
    np.testing.assert_allclose(pt[0:9], pj[0:9], atol=1e-4)  # R_cw
    np.testing.assert_allclose(pt[9:12], pj[9:12], atol=1e-4)  # t_cw
    np.testing.assert_allclose(pt[12:24], pj[12:24], atol=1e-4)  # T_cak
    assert pj[24] > 100 and pj[25] > 100
    assert abs(pt[24] - pj[24]) <= 2 and abs(pt[25] - pj[25]) <= 2
    C = CAND_CAP
    gate_t, gate_j = pt[34:34 + C] > 0.5, pj[34:34 + C] > 0.5
    assert (gate_t == gate_j).mean() >= 0.99


def test_vo_run_parity(frames, jax_run, port_run):
    # The 8-frame forward arc, method 1 both sides: the same keyframes at
    # the same frames, camera positions within 1e-3 m frame by frame, ATE
    # within 1% (relative) or 1e-4 m of JAX's.
    fe, est, drops = port_run
    assert fe.next_kf == jax_run["next_kf"]
    assert drops == jax_run["drops"]
    for Tt, Tj in zip(est, jax_run["est"]):
        assert np.linalg.norm(_position(Tt) - _position(Tj)) < 1e-3
    ate_t = _ate(est, [f["gt"] for f in frames])
    ate_j = jax_run["ate"]
    assert abs(ate_t - ate_j) <= max(0.01 * ate_j, 1e-4), (ate_t, ate_j)


def test_vo_kernel_path(frames):
    # stereo method 2 (the block-matching kernel's semantics; its plain
    # version on the CPU), frames handed over as tensors: the JAX VO test's
    # accuracy bar (tests/test_frontend_vo.py:50)
    before = stereo_bm.block_matching_disparity_bm.launches
    fe, est, _ = _run_port(frames, 2, as_tensors=True)
    assert stereo_bm.block_matching_disparity_bm.launches == before  # CPU
    ate = _ate(est, [f["gt"] for f in frames])
    assert ate < 0.02, ate


def test_external_disparity_path(frames):
    # the ground-truth disparity handed in as a third plane replaces the
    # stereo stage; tracking then stays within the JAX VO test's bar
    seq = SyntheticSequence(J_CAM, n_frames=4)
    fe = TFrontend(T_CAM, TConfig(), device=CPU)
    est = []
    for i in range(4):
        f = dict(_host(frames[i]), disp_gt=np.array(seq.frame(i)["disp_gt"]),
                 use_gt_disp=True)
        if i == 0:
            fe.process_first_frame(f)
        else:
            assert fe.process_frame(f)[0]
        est.append(fe._world_pose())
    assert _ate(est, [f["gt"] for f in frames[:4]]) < 0.02


def test_map_and_packets(port_run):
    # the point map grows and every keyframe produced one packet
    fe, _, _ = port_run
    assert fe.next_point > 0
    assert int(fe.points.valid.sum()) > 100
    assert len(fe.to_optimizer_stack) == fe.next_kf
    pkt = fe.to_optimizer_stack[0]
    assert pkt.kf_id == 0 and len(pkt.new_point_ids) > 100
    assert pkt.new_psi.shape == (len(pkt.new_point_ids), 3)


def test_tracking_failure_reported(frames):
    # a black frame: no corners, no matches -> failure, no crash
    fe = TFrontend(T_CAM, TConfig(), device=CPU)
    fe.process_first_frame(_host(frames[0]))
    blank = {"frame_id": 1, "left": np.zeros_like(frames[0]["left"]),
             "right": np.zeros_like(frames[0]["right"])}
    success, dropped = fe.process_frame(blank)
    assert not success and not dropped


def test_unported_options_raise():
    cfg = TConfig()
    with pytest.raises(NotImplementedError, match="rectif"):
        TFrontend(T_CAM, dataclasses.replace(cfg, framepipe=dataclasses.replace(
            cfg.framepipe, rectify_frame=True)), device=CPU)
    fe = TFrontend(T_CAM, _cfg(TConfig, 3), device=CPU)
    img = np.zeros((192, 256), np.float32)
    with pytest.raises(NotImplementedError, match="BP/CSBP"):
        fe.process_first_frame({"frame_id": 0, "left": img, "right": img})

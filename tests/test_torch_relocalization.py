"""Relocalization after tracking failure in the port's SlamSystem, on the
CPU (port-only mirrors of tests/test_relocalization.py::TestRelocalization):
with a place recognizer the system enters `lost` mode, queries each new
frame against the keyframe index with no covisibility exclusions, and
re-seeds the pose on a passed geometric check; without one a tracking
failure is final."""

import dataclasses

import numpy as np
import pytest
import torch

from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.io.synthetic import SyntheticSequence
from scavislam_tpu_torch.pipeline.slam_system import SlamSystem
from scavislam_tpu_torch.utils.config import Config

CAM = StereoCamera.create(195.0, (127.0, 95.0), (256, 192), 0.12)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cfg():
    cfg = Config()
    return dataclasses.replace(
        cfg,
        frontend=dataclasses.replace(cfg.frontend, covis_thr=10),
        ui=dataclasses.replace(cfg.ui, parallax_thr=0.08),
    )


def _err(system, fid, T_gt):
    T = dict(system.trajectory)[fid]
    return float(np.linalg.norm((T @ T_gt.inverse()).t))


def _noise(rng, fid):
    return {"frame_id": fid,
            "left": rng.rand(192, 256).astype(np.float32),
            "right": rng.rand(192, 256).astype(np.float32)}


def test_recovers_from_kidnap():
    n = 14
    seq = SyntheticSequence(CAM, n_frames=n, step=0.02, device="cpu")
    system = SlamSystem(CAM, small_cfg(), threaded=False, device="cpu")
    frames = [seq.frame(i) for i in range(n)]
    system.process_first_frame(frames[0])
    for f in frames[1:10]:
        assert system.process_frame(dict(f))
    assert len(system.place_recognizer.location_map) >= 1
    assert not system.lost

    # kidnap: three frames of pure noise -> tracking failure -> lost
    rng = np.random.RandomState(0)
    for k in range(3):
        assert system.process_frame(_noise(rng, 100 + k))  # stays alive
    assert system.lost and system.relocalizations == 0

    # wake up at frame 5's viewpoint: relocalize and resume
    recov = dict(frames[5], frame_id=200)
    assert system.process_frame(recov)
    assert not system.lost, "relocalization did not fire"
    assert system.relocalizations == 1
    # the reseed comes from 3-point RANSAC + Horn refine on BoW matches:
    # coarse (decimetres) but inside the guided matcher's capture basin
    assert _err(system, 200, frames[5]["T_cw_gt"]) < 0.25

    # tracking continues from the recovered pose and refines it
    for i in range(6, 9):
        assert system.process_frame(dict(frames[i], frame_id=200 + i))
    assert not system.lost
    assert _err(system, 208, frames[8]["T_cw_gt"]) < 0.08
    system.finish()
    system.shutdown()


def test_unrecoverable_without_place_recognizer():
    seq = SyntheticSequence(CAM, n_frames=4, step=0.02, device="cpu")
    system = SlamSystem(CAM, small_cfg(), threaded=False,
                        enable_loop_closure=False, device="cpu")
    system.process_first_frame(seq.frame(0))
    for i in range(1, 4):
        assert system.process_frame(dict(seq.frame(i)))
    noise = _noise(np.random.RandomState(1), 50)
    assert not system.process_frame(noise)  # reference-like: hard fail
    assert not system.tracking_ok and not system.lost
    system.shutdown()

"""The frozen copies against the port's code as it stands: the renderer
(the input generator), the reference frame step and solve, and
chip_smoke.py's readers. A later change to the port that makes one of
these fail has changed what the benchmark's copy still measures by."""

import numpy as np
import pytest
import torch

from perfbench.core import arith
from perfbench.gen import synthetic as frozen
from perfbench.gen.camera import StereoCamera as RefCamera
from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.io import synthetic as port

CAM = (97.5, (63.5, 47.5), (128, 96), 0.12)


@pytest.mark.parametrize("kind", ["wander", "spin", "forward_arc"])
def test_trajectories_equal(kind):
    a = frozen.make_trajectory(30, kind, 0.06)
    b = port.make_trajectory(30, kind, 0.06)
    for x, y in zip(a, b):
        assert torch.equal(x.R, y.R) and torch.equal(x.t, y.t)


@pytest.mark.parametrize("scene", ["closed_box", "varied_box"])
def test_renderer_equal_at_a_tiny_size(scene):
    planes_f = (frozen.closed_box() if scene == "closed_box"
                else frozen.varied_box(3))
    planes_p = (port.closed_box() if scene == "closed_box"
                else port.varied_box(3))
    assert [tuple(p) for p in planes_f] == [tuple(p) for p in planes_p]
    T = port.make_trajectory(8, "wander", 0.06)[7]
    a = frozen.render_stereo_frame(planes_f, T, RefCamera.create(*CAM))
    b = port.render_stereo_frame(planes_p, T, StereoCamera.create(*CAM))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_noise_equal():
    ga = frozen.noise_generator(2**31 + 5, 3, 1, "cpu")
    gb = port.noise_generator(2**31 + 5, 3, 1, "cpu")
    assert torch.equal(torch.randn(16, generator=ga),
                       torch.randn(16, generator=gb))


def test_reference_step_agrees_with_the_port_on_the_cpu():
    """One frame step of the port and the plain reference from the same
    state: the disparity equal, the pose within the float32 path's reach
    of the float64 reference."""
    from perfbench.checks import stereo_step
    from perfbench.core import check
    from perfbench.reference import frame as ref
    from perfbench.reference.stereo_bm import disparity_of_frames
    from scavislam_tpu_torch.models.frontend import StereoFrontend
    from scavislam_tpu_torch.utils.config import CameraConfig, Config

    cfg = Config(cam=CameraConfig(width=128, height=96, f=97.5, px=63.5,
                                  py=47.5, baseline=0.12))
    cam = StereoCamera.create(*CAM)
    seq = port.SyntheticSequence(cam, n_frames=3, kind="wander",
                                 planes=port.closed_box(), step=0.06,
                                 device="cpu")
    fe = StereoFrontend(cam, cfg, device="cpu")
    kept = check.CallRecorder(fe, "_step", stereo_step.take_state,
                              stereo_step.keep_out)
    frames = [seq.frame(i) for i in range(2)]
    fe.process_first_frame(frames[0])
    kept.arm(1)
    fe.process_frame(frames[1])
    (i, state, out), = kept.samples
    u8 = [torch.stack([check_u8(f["left"]), check_u8(f["right"])])
          for f in frames]
    assert torch.equal(out["disp"], disparity_of_frames(u8[1]))
    x = ref.StepInputs(u8[0], u8[1], disparity_of_frames(u8[0]), state["R"],
                       state["t"], state["poses"], state["points"],
                       state["cand"], out["obs"], out["matched"])
    R, t = ref.frame_pose(x, ref.Camera(97.5, 63.5, 47.5, 0.12),
                          (2, 2, 1), 2.0)
    assert check.pose_gap(out["R"], out["t"], R, t) < 1e-3


def check_u8(img):
    """The frontend's uint8 rounding of a [0, 1] frame."""
    return (torch.clamp(torch.as_tensor(img), 0.0, 1.0) * 255.0
            + 0.5).to(torch.uint8)


def test_chip_smoke_readers_equal():
    import chip_smoke

    for shape in [(1, 384, 512, 64), (8, 384, 512, 64), (1, 8, 8, 16)]:
        assert arith.bound_ms(*shape) == chip_smoke._bound_ms(*shape)
    T = port.make_trajectory(5, "wander", 0.06)
    est = [type("P", (), {"R": x.R.numpy().astype(np.float64),
                          "t": x.t.numpy().astype(np.float64) + 0.01})()
           for x in T]
    assert arith.ate(est, T) == chip_smoke._ate(est, T)

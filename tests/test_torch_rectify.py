"""Undistort + rectify (ops/rectify) and the image ops of the disk slice
(ops/image.preprocess_frame, half_sample_disparity) against the JAX
package on the CPU, and StereoFrontend with framepipe.rectify_frame on.

The maps agree within 1e-4 px (both build them in float64 numpy from a
float32 rotation); the remap of a float stack within 1e-6; of a uint8
stack within one level, and equal on >= 99.9% of pixels (a bilinear value
within an ulp of a rounding boundary may round either way)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scavislam_tpu.core.camera import StereoCamera as JCam
from scavislam_tpu.models.frontend import StereoFrontend as JFrontend
from scavislam_tpu.ops import image as jimage
from scavislam_tpu.ops import rectify as jrect
from scavislam_tpu.utils.config import Config as JConfig
from scavislam_tpu_torch import interop
from scavislam_tpu_torch.core.lie import PoseRT
from scavislam_tpu_torch.io.synthetic import SyntheticSequence
from scavislam_tpu_torch.models.frontend import StereoFrontend as TFrontend
from scavislam_tpu_torch.ops import image as timage
from scavislam_tpu_torch.ops.rectify import (
    Rectifier,
    _rectify_stack,
    build_rectify_map,
    remap,
)
from scavislam_tpu_torch.utils.config import Config as TConfig

J_CAM = JCam.create(195.0, (127.0, 95.0), (256, 192), 0.12)
CAM = interop.camera(np.asarray(J_CAM.focal), np.asarray(J_CAM.pp),
                     J_CAM.size, np.asarray(J_CAM.baseline))
CPU = "cpu"

# (distortion, rotation log): test_aux's three maps, and one with all five
# coefficients and a rotation
MAPS = {
    "identity": ((0, 0, 0, 0, 0), (0, 0, 0)),
    "k1": ((0.05, 0.0, 0, 0, 0), (0, 0, 0)),
    "rotation": ((0, 0, 0, 0, 0), (0.0, 0.02, 0.0)),
    "all_five": ((-0.08, 0.02, 0.001, -0.0015, 0.004), (0.004, -0.01, 0.003)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    seq = SyntheticSequence(CAM, n_frames=4, step=0.02, device=CPU)
    return [seq.frame(i) for i in range(4)]


def _stack_u8(f):
    return torch.stack([
        (torch.clamp(f[k], 0, 1) * 255 + 0.5).to(torch.uint8)
        for k in ("left", "right")])


# -- tests/test_aux.py TestRectify ------------------------------------------

class TestRectify:
    def test_zero_distortion_identity(self):
        m = build_rectify_map(CAM, *MAPS["identity"])
        us, vs = np.meshgrid(np.arange(256), np.arange(192))
        np.testing.assert_allclose(m[..., 0], us, atol=1e-4)
        np.testing.assert_allclose(m[..., 1], vs, atol=1e-4)

    def test_distortion_roundtrip(self):
        m = build_rectify_map(CAM, *MAPS["k1"])
        center_err = np.abs(m[96, 128] - np.array([128, 96])).max()
        corner_err = np.abs(m[10, 10] - np.array([10, 10])).max()
        assert center_err < 1.0 and corner_err > 2.0

    def test_rotation_shifts_image(self):
        m = build_rectify_map(CAM, *MAPS["rotation"])
        # a small y-rotation ~ a horizontal shift by f * angle
        shift = m[96, 128, 0] - 128
        assert abs(abs(shift) - 195.0 * 0.02) < 1.0


@pytest.mark.parametrize("name", sorted(MAPS))
def test_rectify_map_matches_jax(name):
    dist, rot = MAPS[name]
    got = build_rectify_map(CAM, dist, rot)
    want = jrect.build_rectify_map(J_CAM, dist, rot)
    assert got.dtype == np.float32 and got.shape == (192, 256, 2)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _maps():
    ml = build_rectify_map(CAM, *MAPS["all_five"])
    mr = build_rectify_map(CAM, *MAPS["k1"])
    return ml, mr


def test_rectify_stack_f32_matches_jax(frames):
    # a float stack with an external disparity plane, passed through
    f = frames[1]
    stack = torch.stack([f["left"], f["right"], f["disp_gt"]])
    ml, mr = _maps()
    got = _rectify_stack(stack, torch.as_tensor(ml), torch.as_tensor(mr))
    want = np.asarray(jrect._rectify_stack(jnp.asarray(stack.numpy()),
                                           jnp.asarray(ml), jnp.asarray(mr)))
    assert got.dtype == torch.float32 and got.shape == (3, 192, 256)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert torch.equal(got[2], stack[2])


def test_rectify_stack_u8_matches_jax(frames):
    stack = _stack_u8(frames[1])
    ml, mr = _maps()
    got = _rectify_stack(stack, torch.as_tensor(ml), torch.as_tensor(mr))
    want = np.asarray(jrect._rectify_stack(jnp.asarray(stack.numpy()),
                                           jnp.asarray(ml), jnp.asarray(mr)))
    assert got.dtype == torch.uint8
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999, (diff == 0).mean()


def test_identity_rectify_is_exact(frames):
    # zero distortion, no rotation: every tap lands on a pixel, and
    # (x / 255) * 255 + 0.5 rounds back to x
    cfg = TConfig()
    cfg = dataclasses.replace(cfg, framepipe=dataclasses.replace(
        cfg.framepipe, rectify_frame=True))
    rect = Rectifier(CAM, cfg, device=CPU)
    stack = _stack_u8(frames[2])
    assert torch.equal(rect.rectify_stacked(stack), stack)
    f32 = torch.stack([frames[2]["left"], frames[2]["right"]])
    assert torch.equal(rect.rectify_stacked(f32), f32)
    left, right = rect(f32[0], f32[1])
    assert torch.equal(left, f32[0]) and torch.equal(right, f32[1])
    assert torch.equal(remap(f32[0], rect.map_left), f32[0])


def test_rectifier_off_is_a_no_op(frames):
    rect = Rectifier(CAM, TConfig())
    stack = _stack_u8(frames[0])
    assert rect.rectify_stacked(stack) is stack


def _rect_cfg(cls, dist, rectify=True):
    cfg = cls()
    return dataclasses.replace(
        cfg,
        cam=dataclasses.replace(cfg.cam, dist_left=dist, dist_right=dist),
        framepipe=dataclasses.replace(cfg.framepipe, rectify_frame=rectify),
        ui=dataclasses.replace(cfg.ui, stereo_method=1))


def _run_frontend(fe, frames):
    fe.process_first_frame(frames[0])
    for f in frames[1:]:
        ok, _ = fe.process_frame(f)
        assert ok
    return PoseRT.from_any(fe._world_pose())


def _host(f):
    return {"frame_id": f["frame_id"], "left": f["left"].numpy(),
            "right": f["right"].numpy()}


def test_frontend_rectify_identity_matches_plain(frames):
    """rectify_frame on with zero distortion tracks the same poses as the
    plain path (the twin's slow test_pipeline_wiring_identity, on the
    port)."""
    host = [_host(f) for f in frames]
    zero = (0, 0, 0, 0, 0)
    plain = _run_frontend(
        TFrontend(CAM, _rect_cfg(TConfig, zero, False), device=CPU), host)
    rect = _run_frontend(
        TFrontend(CAM, _rect_cfg(TConfig, zero), device=CPU), host)
    np.testing.assert_array_equal(rect.R, plain.R)
    np.testing.assert_array_equal(rect.t, plain.t)


def test_frontend_rectify_matches_jax(frames):
    # the k1 = 0.05 map on both eyes, stereo method 1 on both sides (the
    # JAX package runs that twin on the CPU)
    host = [_host(f) for f in frames]
    dist = MAPS["k1"][0]
    t = _run_frontend(TFrontend(CAM, _rect_cfg(TConfig, dist), device=CPU),
                      host)
    j = _run_frontend(JFrontend(J_CAM, _rect_cfg(JConfig, dist)), host)
    d = (t @ PoseRT.from_any(j).inverse()).log()
    assert float(torch.abs(d).max()) < 1e-3


# -- ops/image: the frame preprocessing and disparity decimation -----------

@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_preprocess_frame_matches_jax(frames, dtype):
    img = frames[0]["left"].numpy()
    if dtype == "uint8":
        img = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    got = timage.preprocess_frame(torch.as_tensor(img), 3)
    want = jimage.preprocess_frame(jnp.asarray(img), 3)
    for key in ("pyr", "dx", "dy"):
        assert len(got[key]) == 3
        for g, w in zip(got[key], want[key]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                       rtol=0)


def test_half_sample_disparity_matches_jax(frames):
    disp = frames[0]["disp_gt"]
    got = timage.half_sample_disparity(disp, None, 2)
    want = jimage.half_sample_disparity(jnp.asarray(disp.numpy()), None, 2)
    assert got.shape == (96, 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

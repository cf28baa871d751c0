"""The renderer's degradations and free-standing primitives
(io/synthetic: Degradation, _degrade_view, _apply_occluder, Box, Sphere,
cluttered_room) on the CPU: tests/test_io.py's TestDegradation and
TestClutteredScene mirrored against the port, and parity with the JAX
package on shared inputs. The noise is drawn from a torch.Generator and
cannot replay jax.random, so it is held statistically; every other effect
is held to 1e-6 (images) or 1e-5 (ray distances)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scavislam_tpu.core.camera import StereoCamera as JCam
from scavislam_tpu.io import synthetic as jsyn
from scavislam_tpu_torch import interop
from scavislam_tpu_torch.core.lie import SE3
from scavislam_tpu_torch.io.synthetic import (
    Box,
    Degradation,
    Sphere,
    SyntheticSequence,
    _apply_occluder,
    _degrade_view,
    _intersect_box,
    _intersect_sphere,
    cluttered_room,
    default_room,
    render_stereo_frame,
)

J_CAM = JCam.create(60.0, (31.5, 23.5), (64, 48), 0.12)
CAM = interop.camera(np.asarray(J_CAM.focal), np.asarray(J_CAM.pp),
                     J_CAM.size, np.asarray(J_CAM.baseline))
CPU = "cpu"


def _left(seq, i):
    return seq.frame(i)["left"].numpy()


def _identity():
    return SE3(torch.eye(3), torch.zeros(3))


# -- tests/test_io.py TestDegradation ---------------------------------------

class TestDegradation:
    def test_deterministic_per_frame(self):
        deg = Degradation(noise_std=0.03, exposure_amp=0.1, vignette=0.3,
                          occluder_frac=0.25)
        seq = SyntheticSequence(CAM, n_frames=6, degrade=deg, device=CPU)
        a = seq.frame(2)
        b = seq.frame(2)
        assert torch.equal(a["left"], b["left"])
        # noise is independent across frames and eyes
        c = seq.frame(3)
        assert (a["left"] - c["left"]).abs().max() > 0
        assert (a["left"] - a["right"]).abs().max() > 0

    def test_noise_std_calibrated(self):
        clean = _left(SyntheticSequence(CAM, n_frames=4, device=CPU), 1)
        noisy = _left(SyntheticSequence(
            CAM, n_frames=4, degrade=Degradation(noise_std=0.05),
            device=CPU), 1)
        d = noisy - clean
        interior = (clean > 0.15) & (clean < 0.85)  # away from the clip
        assert interior.sum() > 200
        assert 0.035 < d[interior].std() < 0.065

    def test_exposure_gain_is_exact(self):
        deg = Degradation(exposure_amp=0.2, exposure_period=40.0)
        i = 10  # sin peak: gain = 1 + amp
        cl = _left(SyntheticSequence(CAM, n_frames=12, device=CPU), i)
        ex = _left(SyntheticSequence(CAM, n_frames=12, degrade=deg,
                                     device=CPU), i)
        interior = (cl > 0.1) & (cl * 1.2 < 0.999)
        np.testing.assert_allclose(ex[interior] / cl[interior], 1.2,
                                   atol=1e-3)

    def test_motion_blur_softens_gradients(self):
        clean = _left(SyntheticSequence(CAM, n_frames=3, device=CPU), 1)
        blurred = _left(SyntheticSequence(
            CAM, n_frames=3, degrade=Degradation(motion_blur=1.0),
            device=CPU), 1)

        def gu(im):
            return np.abs(np.diff(im, axis=1)).mean()

        def gv(im):
            return np.abs(np.diff(im, axis=0)).mean()

        ru = gu(blurred) / gu(clean)
        rv = gv(blurred) / gv(clean)
        # the blur is directional: vertical gradients survive much better
        assert ru < 0.6, ru
        assert rv > 1.5 * ru, (ru, rv)

    def test_occluder_consistent_geometry(self):
        deg = Degradation(occluder_frac=0.25, occluder_depth=1.2)
        f = SyntheticSequence(CAM, n_frames=8, degrade=deg,
                              device=CPU).frame(4)
        disp = f["disp_gt"].numpy()
        depth = f["depth_gt"].numpy()
        d_occ = CAM.focal * CAM.baseline / 1.2
        box = np.isclose(disp, d_occ, atol=1e-4)
        side = 0.25 * 64
        assert 0.5 * side * side < box.sum() < 2.0 * side * side
        np.testing.assert_allclose(depth[box], 1.2, atol=1e-5)


# -- tests/test_io.py TestClutteredScene ------------------------------------

class TestClutteredScene:
    def test_interior_depth_discontinuities(self):
        left, _, disp, depth = (x.numpy() for x in render_stereo_frame(
            cluttered_room(0), _identity(), CAM))
        lp, _, dp_, _ = (x.numpy() for x in render_stereo_frame(
            default_room(), _identity(), CAM))
        assert np.isfinite(depth).all() and (depth > 0.1).all()
        assert np.abs(left - lp).max() > 0.01, "no object visible"
        int_g = np.abs(np.diff(disp, axis=1))[4:-4, 4:-4]
        pla_g = np.abs(np.diff(dp_, axis=1))[4:-4, 4:-4]
        assert pla_g.max() < 1.0, "planes scene unexpectedly discontinuous"
        assert (int_g > 2.0).sum() >= 10, "no interior disparity jumps"
        assert np.isfinite(disp).all()

    def test_sphere_and_box_intersections(self):
        origin = torch.zeros(3)
        dirs = torch.tensor([[0, 0, 1.0], [0, 0, -1.0], [1.0, 0, 0]])
        box = Box((-0.5, -0.5, 2.0), (0.5, 0.5, 3.0), 0.0)
        t = _intersect_box(origin, dirs, box).numpy()
        np.testing.assert_allclose(t[0], 2.0, atol=1e-5)
        assert np.isinf(t[1]) and np.isinf(t[2])
        sp = Sphere((0, 0, 4.0), 1.0, 0.0)
        t = _intersect_sphere(origin, dirs, sp).numpy()
        np.testing.assert_allclose(t[0], 3.0, atol=1e-4)
        assert np.isinf(t[1]) and np.isinf(t[2])
        # a ray starting inside the sphere exits through the far surface
        t_in = _intersect_sphere(torch.tensor([0, 0, 4.0]), dirs, sp).numpy()
        np.testing.assert_allclose(t_in[0], 1.0, atol=1e-4)


# -- parity with the JAX package on shared inputs ---------------------------

def _image(seed=0):
    # a smooth image in [0, 1] with texture at every scale
    rng = np.random.RandomState(seed)
    return np.clip(0.5 + 0.3 * rng.randn(48, 64), 0, 1).astype(np.float32)


@pytest.mark.parametrize("deg", [
    Degradation(motion_blur=0.7),
    Degradation(vignette=0.4),
    Degradation(exposure_amp=0.15, exposure_period=23.0),
    Degradation(motion_blur=0.5, vignette=0.3, exposure_amp=0.1),
], ids=["blur", "vignette", "exposure", "all"])
@pytest.mark.parametrize("i", [0, 7])
def test_degrade_view_matches_jax(deg, i):
    img = _image(i)
    for eye in (0, 1):
        got = _degrade_view(torch.as_tensor(img), i, eye, deg, CAM).numpy()
        want = np.asarray(jsyn._degrade_view(
            jnp.asarray(img), i, eye, jsyn.Degradation(*deg), J_CAM))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("i", [0, 3, 7])
def test_apply_occluder_matches_jax(i):
    # zero images: the occluder's masks are where the output is nonzero
    # (its texture is >= 0.08); disparity and depth are written exactly
    rng = np.random.RandomState(i)
    zeros = np.zeros((48, 64), np.float32)
    disp = (5 + rng.rand(48, 64)).astype(np.float32)
    depth = (2 + rng.rand(48, 64)).astype(np.float32)
    deg = Degradation(occluder_frac=0.3, occluder_depth=1.1)
    got = [x.numpy() for x in _apply_occluder(
        *(torch.as_tensor(a) for a in (zeros, zeros, disp, depth)), i, 8, deg,
        CAM)]
    want = [np.asarray(x) for x in jsyn._apply_occluder(
        *(jnp.asarray(a) for a in (zeros, zeros, disp, depth)), i, 8,
        jsyn.Degradation(*deg), J_CAM)]
    for k in (0, 1):  # left and right masks
        np.testing.assert_array_equal(got[k] > 0, want[k] > 0)
        assert (got[k] > 0).sum() > 100
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])


def test_cluttered_room_matches_jax():
    for seed in (0, 5):
        got, want = cluttered_room(seed), jsyn.cluttered_room(seed)
        assert [type(p).__name__ for p in got] == [
            type(p).__name__ for p in want]
        for p, q in zip(got, want):
            for a, b in zip(p, q):
                np.testing.assert_array_equal(
                    np.asarray(a, np.float32), np.asarray(b, np.float32))


def _rays(n=400, seed=0):
    rng = np.random.RandomState(seed)
    dirs = rng.randn(n, 3).astype(np.float32)
    dirs[:, 2] = np.abs(dirs[:, 2]) + 0.2  # mostly forward
    dirs[:5, 0] = 0.0  # axis-parallel components: the slab's 1e-9 guard
    origin = np.float32([0.1, -0.05, 0.2])
    return origin, dirs


def test_intersect_box_matches_jax():
    origin, dirs = _rays()
    for box in [p for p in cluttered_room(3) if isinstance(p, Box)]:
        got = _intersect_box(torch.as_tensor(origin), torch.as_tensor(dirs),
                             box).numpy()
        jbox = jsyn.Box(jnp.asarray(np.float32(box.lo)),
                        jnp.asarray(np.float32(box.hi)),
                        jnp.float32(box.tex_phase))
        want = np.asarray(jsyn._intersect_box(jnp.asarray(origin),
                                              jnp.asarray(dirs), jbox))
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        assert np.isfinite(got).sum() > 0
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], atol=1e-5, rtol=0)


def test_intersect_sphere_matches_jax():
    origin, dirs = _rays(seed=1)
    for sp in [p for p in cluttered_room(3) if isinstance(p, Sphere)]:
        got = _intersect_sphere(torch.as_tensor(origin),
                                torch.as_tensor(dirs), sp).numpy()
        jsp = jsyn.Sphere(jnp.asarray(np.float32(sp.center)),
                          jnp.float32(sp.radius), jnp.float32(sp.tex_phase))
        want = np.asarray(jsyn._intersect_sphere(jnp.asarray(origin),
                                                 jnp.asarray(dirs), jsp))
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        assert np.isfinite(got).sum() > 0
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], atol=1e-5, rtol=0)


def test_cluttered_render_geometry_matches_jax():
    # depth and disparity of a cluttered frame agree to f32 rounding
    T = jsyn.make_trajectory(3, "forward_arc", 0.05)[2]
    _, _, jdisp, jdepth = jsyn.render_stereo_frame(jsyn.cluttered_room(1), T,
                                                   J_CAM)
    Tt = SE3(torch.as_tensor(np.array(T.R)), torch.as_tensor(np.array(T.t)))
    _, _, disp, depth = render_stereo_frame(cluttered_room(1), Tt, CAM)
    np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth), rtol=1e-5)
    np.testing.assert_allclose(disp.numpy(), np.asarray(jdisp), rtol=1e-5)

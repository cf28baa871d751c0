"""The port's image, block-matching and patch ops against the JAX package's,
on the CPU: the cases of tests/test_ops_image.py and tests/test_ops_stereo.py
on the same numpy inputs, and ops.patches' public functions (extract_patches,
extract_patches_warped, zmssd, patch_variance) on a rendered frame.

tests/test_torch_stereo_bm.py holds the block-matching kernel's plain version
against the Pallas kernel in interpret mode; here test_ops_stereo.py's own
fourth case (the fused kernel against the cost-volume formulation) runs on
the port's two block matchers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scavislam_tpu.core.camera import StereoCamera as JCam
from scavislam_tpu.io.synthetic import SyntheticSequence
from scavislam_tpu.ops import image as jimg
from scavislam_tpu.ops import patches as jpat
from scavislam_tpu.ops import stereo as jst
from scavislam_tpu_torch.ops import image as timg
from scavislam_tpu_torch.ops import patches as tpat
from scavislam_tpu_torch.ops import stereo as tst
from scavislam_tpu_torch.ops import stereo_bm

# the 256x192 stereo-test camera (tests/test_ops_stereo.py)
CAM = JCam.create(195.0, (127.0, 95.0), (256, 192), 0.35)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def pair():
    f = SyntheticSequence(CAM, n_frames=1).frame(0)
    return (np.array(f["left"]), np.array(f["right"]), np.array(f["disp_gt"]))


# -- ops.image (tests/test_ops_image.py) -----------------------------------------

class TestPyramid:
    def test_shapes(self):
        pyr = timg.build_pyramid(torch.zeros(384, 512), 3)
        assert [tuple(p.shape) for p in pyr] == [(384, 512), (192, 256),
                                                 (96, 128)]

    def test_constant_preserved(self):
        for p in timg.build_pyramid(torch.full((64, 64), 0.5), 3):
            np.testing.assert_allclose(p.numpy(), 0.5, atol=1e-6)


class TestSobel:
    def test_linear_ramp_gradient(self):
        # I(u, v) = 0.01 u: dx = 0.01, dy = 0 in the interior; and the
        # twin's gradients within 1e-7 everywhere
        img = np.broadcast_to(0.01 * np.arange(32, dtype=np.float32)[None, :],
                              (32, 32)).copy()
        dx, dy = timg.sobel_xy(_t(img))
        np.testing.assert_allclose(dx[2:-2, 2:-2].numpy(), 0.01, atol=1e-5)
        np.testing.assert_allclose(dy[2:-2, 2:-2].numpy(), 0.0, atol=1e-5)
        jx, jy = jimg.sobel_xy(jnp.asarray(img))
        np.testing.assert_allclose(dx.numpy(), np.asarray(jx), atol=1e-7)
        np.testing.assert_allclose(dy.numpy(), np.asarray(jy), atol=1e-7)


class TestPreprocess:
    def test_uint8_scaling(self):
        img = np.full((64, 64), 128, np.uint8)
        out = timg.preprocess_frame(_t(img), 3)
        np.testing.assert_allclose(out["pyr"][0].numpy(), 128.0 / 255.0,
                                   atol=1e-6)
        assert len(out["pyr"]) == 3 and len(out["dx"]) == 3
        ref = jimg.preprocess_frame(jnp.asarray(img), 3)
        for key in ("pyr", "dx", "dy"):
            for a, b in zip(out[key], ref[key]):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           atol=1e-7)


class TestBilinear:
    def test_exact_on_grid(self):
        img = torch.arange(16.0).reshape(4, 4)
        vals, ok = timg.bilinear_sample(img, _t([[1.0, 2.0], [3.0, 0.0]]))
        np.testing.assert_allclose(vals.numpy(), [img[2, 1], img[0, 3]])
        assert ok.all()

    def test_midpoint(self):
        val, _ = timg.bilinear_sample(_t([[0.0, 1.0], [2.0, 3.0]]),
                                      _t([0.5, 0.5]))
        np.testing.assert_allclose(val.numpy(), 1.5)

    def test_out_of_bounds(self):
        val, ok = timg.bilinear_sample(torch.ones(4, 4), _t([-1.0, 0.0]),
                                       fill=-9.0)
        assert not bool(ok)
        np.testing.assert_allclose(val.numpy(), -9.0)

    def test_nearest(self):
        img = torch.arange(16.0).reshape(4, 4)
        val, _ = timg.nearest_sample(img, _t([1.4, 2.6]))
        np.testing.assert_allclose(val.numpy(), img[3, 1].numpy())


class TestBinomial3:
    def test_interior_matches_explicit_convolution(self):
        img = np.random.RandomState(3).rand(32, 40).astype(np.float32)
        out = timg.binomial3(_t(img)).numpy()
        k = np.array([0.25, 0.5, 0.25], np.float32)
        ref = np.zeros_like(img)
        for dy, wy in zip((-1, 0, 1), k):
            for dx, wx in zip((-1, 0, 1), k):
                ref += wy * wx * np.roll(np.roll(img, dy, 0), dx, 1)
        np.testing.assert_allclose(out, ref, atol=1e-6)
        np.testing.assert_array_equal(
            out, np.asarray(jimg.binomial3(jnp.asarray(img))))

    def test_preserves_mean_and_reduces_noise(self):
        rng = np.random.RandomState(0)
        img = 0.5 + 0.1 * rng.randn(64, 64).astype(np.float32)
        out = timg.binomial3(_t(img)).numpy()
        np.testing.assert_allclose(out.mean(), img.mean(), atol=1e-6)
        assert out.std() < 0.5 * img.std()


# -- ops.stereo (tests/test_ops_stereo.py) ---------------------------------------

@pytest.fixture(scope="module")
def bm64(pair):
    left, right, _ = pair
    return tst.block_matching_disparity(_t(left), _t(right), num_disp=64,
                                        radius=5).numpy()


class TestBlockMatching:
    def test_disparity_accuracy(self, pair, bm64):
        _, _, g = pair
        d = bm64
        m = (d > 0) & (g > 1.0) & (g < 63.0)
        m[:8, :] = m[-8:, :] = False
        m[:, :8] = m[:, -8:] = False
        assert m.sum() > 2000, f"too few valid disparities: {m.sum()}"
        err = np.abs(d[m] - g[m])
        assert np.median(err) < 0.5, f"median err {np.median(err)}"
        assert (err < 2.0).mean() > 0.9, f"inlier rate {(err < 2.0).mean()}"

    def test_invalid_marked_negative(self, bm64):
        assert (bm64[:, :4] <= 0).all()

    def test_textureless_rejected(self):
        flat = torch.full((96, 128), 0.5)
        d = tst.block_matching_disparity(flat, flat, num_disp=32)
        assert (d <= 0).all()
        dj = jst.block_matching_disparity(jnp.asarray(flat.numpy()),
                                          jnp.asarray(flat.numpy()),
                                          num_disp=32)
        np.testing.assert_array_equal(d.numpy(), np.asarray(dj))

    def test_kernel_plain_matches_cost_volume(self, pair):
        # the fused kernel's semantics (its plain version on the CPU) against
        # the cost-volume formulation at D = 32, the twin's bar: > 50% valid
        # in both, > 97% of those within 1 px, median error < 0.5 px
        left, right, g = pair
        dk = stereo_bm.block_matching_disparity_bm(
            _t(left), _t(right), num_disp=32, radius=5).numpy()
        dx = tst.block_matching_disparity(_t(left), _t(right), num_disp=32,
                                          radius=5).numpy()
        both = (dk > 0) & (dx > 0)
        assert both.mean() > 0.5
        assert (np.abs(dk[both] - dx[both]) < 1.0).mean() > 0.97
        m = both & (g > 1) & (g < 31)
        assert np.median(np.abs(dk[m] - g[m])) < 0.5


# -- ops.patches -------------------------------------------------------------------

@pytest.fixture(scope="module")
def patch_inputs(pair):
    """Corners across the frame (a few near the border, so some patches
    leave the image), random affine warps near the identity, and 6
    candidates per reference."""
    rng = np.random.default_rng(5)
    n = 40
    uv = np.stack([rng.uniform(-2, 258, n), rng.uniform(-2, 194, n)],
                  -1).astype(np.float32)
    A = (np.eye(2, dtype=np.float32)
         + 0.2 * rng.normal(size=(n, 2, 2))).astype(np.float32)
    return pair[0], uv, A


def test_extract_patches_match_jax(patch_inputs):
    # bilinear taps at the same coordinates: within 1e-6 on [0, 1] values,
    # the same in-image masks, with some patches out of the image
    img, uv, A = patch_inputs
    for size in (8, 16):
        vt, okt = tpat.extract_patches(_t(img), _t(uv), size)
        vj, okj = jpat.extract_patches(jnp.asarray(img), jnp.asarray(uv), size)
        np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
        assert 0 < okt.sum() < len(uv)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-6)
    vt, okt = tpat.extract_patches_warped(_t(img), _t(uv), _t(A))
    vj, okj = jpat.extract_patches_warped(jnp.asarray(img), jnp.asarray(uv),
                                          jnp.asarray(A))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-6)
    np.testing.assert_array_equal(tpat._patch_offsets(8),
                                  jpat._patch_offsets(8))


def test_zmssd_and_variance_match_jax(patch_inputs):
    # ZMSSD of every reference against 6 candidates (the reference itself,
    # a brightness-shifted copy and 4 others): within 1e-5 of the twin's on
    # scores of ~0.1-10; zero for the reference and its shifted copy (zero
    # mean); the variance within 1e-7
    img, uv, _ = patch_inputs
    ref, _ = tpat.extract_patches(_t(img), _t(uv))
    idx = np.random.default_rng(6).integers(0, len(uv), size=(len(uv), 4))
    cands = torch.cat([ref[:, None], ref[:, None] + 0.1, ref[_t(idx)]], 1)
    st = tpat.zmssd(ref, cands)
    sj = jpat.zmssd(jnp.asarray(ref.numpy()), jnp.asarray(cands.numpy()))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5)
    np.testing.assert_allclose(st[:, :2].numpy(), 0.0, atol=1e-4)
    assert (st[:, 2:] >= -1e-4).all()
    vt = tpat.patch_variance(ref)
    np.testing.assert_allclose(vt.numpy(), np.asarray(
        jpat.patch_variance(jnp.asarray(ref.numpy()))), atol=1e-7)

"""The port's RANSAC (scavislam_tpu_torch.ops.ransac) against the JAX
package's on the same numpy inputs, on the CPU. The hypothesis draw is the
one thing the frameworks cannot share: the JAX side's indices are computed
by replaying its key chain and handed to the port's scorer. Plus the
port-only mirrors of tests/test_placerec.py::TestRansac on a seeded
torch.Generator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scavislam_tpu.core.lie import SE3 as JSE3
from scavislam_tpu.ops import ransac as jr
from scavislam_tpu_torch.core.lie import SE3
from scavislam_tpu_torch.ops import ransac as tr

CAM_PARAMS = (195.0, 127.0, 95.0, 0.12)


def _t(x):
    return torch.as_tensor(np.array(x))


def _scene(seed, n=120, outliers=0.4, invalid=0.15, scale=1.0):
    """Points in frame A, their images in frame B under a known motion,
    a fraction corrupted and a fraction marked invalid (padding)."""
    rng = np.random.RandomState(seed)
    xyz_a = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1, 1, n),
                      rng.uniform(3, 7, n)], -1).astype(np.float32)
    T = JSE3.exp(jnp.asarray(rng.uniform(-0.2, 0.2, 6).astype(np.float32)))
    xyz_b = np.asarray(scale * (xyz_a @ np.asarray(T.R).T) + np.asarray(T.t),
                       np.float32)
    bad = rng.rand(n) < outliers
    xyz_b[bad] += rng.randn(int(bad.sum()), 3).astype(np.float32)
    valid = rng.rand(n) > invalid
    return xyz_a, xyz_b, valid


def test_horn_abs_orientation_matches_jax():
    # R, t within 1e-5 over a batch of random triplets
    rng = np.random.RandomState(0)
    A = rng.randn(256, 3, 3).astype(np.float32) * 2
    B = rng.randn(256, 3, 3).astype(np.float32) * 2
    Rj, tj = jax.vmap(jr._horn_abs_orientation)(jnp.asarray(A), jnp.asarray(B))
    Rt, tt = tr._horn_abs_orientation(_t(A), _t(B))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5, rtol=0)
    sj, Rj, tj = jax.vmap(jr._horn_sim3)(jnp.asarray(A), jnp.asarray(B))
    st, Rt, tt = tr._horn_sim3(_t(A), _t(B))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5,
                               rtol=1e-5)


def test_refine_se3_from_inliers_matches_jax():
    xyz_a, xyz_b, valid = _scene(1)
    Tj = jr.refine_se3_from_inliers(jnp.asarray(xyz_a), jnp.asarray(xyz_b),
                                    jnp.asarray(valid))
    Tt = tr.refine_se3_from_inliers(_t(xyz_a), _t(xyz_b), _t(valid))
    np.testing.assert_allclose(Tt.R.numpy(), np.asarray(Tj.R), atol=1e-5)
    np.testing.assert_allclose(Tt.t.numpy(), np.asarray(Tj.t), atol=1e-5)
    # no inlier at all: the zero cross-covariance gives the identity
    none = np.zeros(len(valid), bool)
    Tj = jr.refine_se3_from_inliers(jnp.asarray(xyz_a), jnp.asarray(xyz_b),
                                    jnp.asarray(none))
    Tt = tr.refine_se3_from_inliers(_t(xyz_a), _t(xyz_b), _t(none))
    np.testing.assert_allclose(Tt.R.numpy(), np.asarray(Tj.R), atol=1e-6)


@pytest.mark.parametrize("seed", [2, 3])
def test_ransac_se3_matches_jax_on_replayed_draws(seed):
    # the twin's draw: split(key) -> k1, randint(k1, (256, 3), 0, n); the
    # same inlier mask and count, R and t within 1e-5
    xyz_a, xyz_b, valid = _scene(seed)
    key = jax.random.PRNGKey(seed)
    k1, _ = jax.random.split(key)
    idx = np.asarray(jax.random.randint(k1, (256, 3), 0, len(valid)))
    Rj, tj, inj, nj = jr.ransac_se3(key, jnp.asarray(xyz_a),
                                    jnp.asarray(xyz_b), jnp.asarray(valid),
                                    CAM_PARAMS)
    Rt, tt, int_, nt = tr.ransac_se3(_t(idx), _t(xyz_a), _t(xyz_b),
                                     _t(valid), CAM_PARAMS)
    assert int(nt) == int(nj) > 40
    np.testing.assert_array_equal(int_.numpy(), np.asarray(inj))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)


def test_ransac_sim3_matches_jax_on_replayed_draws():
    # the twin's sim3 draw is randint(key, (256, 3), 0, n) with no split
    xyz_a, xyz_b, valid = _scene(4, scale=1.3)
    key = jax.random.PRNGKey(4)
    idx = np.asarray(jax.random.randint(key, (256, 3), 0, len(valid)))
    sj, Rj, tj, inj, nj = jr.ransac_sim3(
        key, jnp.asarray(xyz_a), jnp.asarray(xyz_b), jnp.asarray(valid),
        CAM_PARAMS)
    st, Rt, tt, int_, nt = tr.ransac_sim3(_t(idx), _t(xyz_a), _t(xyz_b),
                                          _t(valid), CAM_PARAMS)
    assert int(nt) == int(nj) > 40
    np.testing.assert_array_equal(int_.numpy(), np.asarray(inj))
    np.testing.assert_allclose(float(st), float(sj), atol=1e-5)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)


# -- port-only mirrors of tests/test_placerec.py::TestRansac --------------- #

def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _max_err(T, T_gt):
    return float(torch.max(torch.abs((T @ T_gt.inverse()).log())))


def test_exact_correspondences():
    g = _gen(0)
    n = 64
    xyz_a = torch.stack([torch.rand(n, generator=g) * 4 - 2,
                         torch.rand(n, generator=g) * 2 - 1,
                         torch.rand(n, generator=g) * 4 + 3], dim=-1)
    T_gt = SE3.exp(torch.tensor([0.3, -0.1, 0.2, 0.05, -0.1, 0.08]))
    xyz_b = T_gt.apply(xyz_a)
    idx = tr.draw_hypotheses(n, 256, g)
    R, t, inl, n_in = tr.ransac_se3(idx, xyz_a, xyz_b,
                                    torch.ones(n, dtype=torch.bool),
                                    CAM_PARAMS)
    assert int(n_in) > 0.9 * n
    assert _max_err(SE3(R, t), T_gt) < 1e-3


def test_with_outliers():
    g = _gen(1)
    n = 80
    xyz_a = torch.stack([torch.randn(n, generator=g),
                         torch.randn(n, generator=g),
                         torch.rand(n, generator=g) * 4 + 3], dim=-1)
    T_gt = SE3.exp(torch.tensor([0.2, 0.1, -0.15, -0.03, 0.06, 0.02]))
    xyz_b = T_gt.apply(xyz_a)
    bad = torch.rand(n, generator=g) < 0.4  # corrupt 40%
    xyz_b = torch.where(bad[:, None],
                        xyz_b + torch.randn((n, 3), generator=g) * 2.0, xyz_b)
    idx = tr.draw_hypotheses(n, 256, g)
    R, t, inl, n_in = tr.ransac_se3(idx, xyz_a, xyz_b,
                                    torch.ones(n, dtype=torch.bool),
                                    CAM_PARAMS)
    T_ref = tr.refine_se3_from_inliers(xyz_a, xyz_b, inl)
    assert _max_err(T_ref, T_gt) < 5e-3

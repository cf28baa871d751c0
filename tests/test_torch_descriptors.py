"""The port's gradient descriptors, matcher and bag-of-words describe
(scavislam_tpu_torch.ops.descriptors) against the JAX package's on the same
numpy inputs, on the CPU at 256x192, plus the port-only mirrors of
tests/test_placerec.py::TestDescriptors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scavislam_tpu.core.camera import StereoCamera as JCam
from scavislam_tpu.io.synthetic import SyntheticSequence as JSeq
from scavislam_tpu.models import placerec as jpr
from scavislam_tpu.ops import descriptors as jd
from scavislam_tpu.ops.image import sobel_xy as j_sobel
from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.io.synthetic import SyntheticSequence
from scavislam_tpu_torch.models import placerec as tpr
from scavislam_tpu_torch.ops import descriptors as td
from scavislam_tpu_torch.ops.image import sobel_xy

J_CAM = JCam.create(195.0, (127.0, 95.0), (256, 192), 0.12)
CAM = StereoCamera.create(195.0, (127.0, 95.0), (256, 192), 0.12)
CAM_PARAMS = (float(J_CAM.focal), float(J_CAM.pp[0]), float(J_CAM.pp[1]),
              float(J_CAM.baseline))


@pytest.fixture(scope="module")
def jframes():
    seq = JSeq(J_CAM, n_frames=12, step=0.05)
    return [{k: np.asarray(seq.frame(i)[k]) for k in ("left", "disp_gt")}
            for i in (0, 11)]


@pytest.fixture(scope="module")
def vocab():
    return tpr.default_vocabulary()


def _t(x):
    return torch.as_tensor(np.array(x))


def test_compute_descriptors_matches_jax(jframes):
    # valid equal; descriptors within 1e-5 abs on the valid rows
    img = jframes[0]["left"]
    rng = np.random.RandomState(0)
    uv = np.concatenate([
        rng.uniform(0, 256, (60, 1)), rng.uniform(0, 192, (60, 1))],
        axis=1).astype(np.float32)
    uv[:4] = [[3.0, 50.0], [250.0, 100.0], [120.0, 2.0], [7.5, 7.5]]
    scale = rng.uniform(0.5, 2.0, 60).astype(np.float32)
    jdx, jdy = j_sobel(jnp.asarray(img))
    tdx, tdy = sobel_xy(_t(img))
    for sc in (None, scale):
        dj, vj = jd.compute_descriptors(
            jdx, jdy, jnp.asarray(uv), None if sc is None else jnp.asarray(sc))
        dt, vt = td.compute_descriptors(tdx, tdy, _t(uv),
                                        None if sc is None else _t(sc))
        vj = np.asarray(vj)
        np.testing.assert_array_equal(vt.numpy(), vj)
        assert 10 < vj.sum() < 60
        np.testing.assert_allclose(dt.numpy()[vj], np.asarray(dj)[vj],
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_match_descriptors_matches_jax(masked):
    # idx and ok equal, with and without the padded masks
    rng = np.random.RandomState(1)
    a = rng.randn(96, 128).astype(np.float32)
    b = np.concatenate([a[:40] + 0.05 * rng.randn(40, 128),
                        rng.randn(60, 128)]).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    va = rng.rand(96) > 0.2 if masked else None
    vb = rng.rand(100) > 0.3 if masked else None
    if masked:
        vb[80:] = False
    ij, oj = jd.match_descriptors(
        jnp.asarray(a), jnp.asarray(b),
        valid_a=None if va is None else jnp.asarray(va),
        valid_b=None if vb is None else jnp.asarray(vb))
    it, ot = td.match_descriptors(
        _t(a), _t(b), valid_a=None if va is None else _t(va),
        valid_b=None if vb is None else _t(vb))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    assert 20 < int(ot.sum()) < 96
    # every b row masked: argmax keeps column 0 and nothing is ok
    vb0 = np.zeros(100, bool)
    ij, oj = jd.match_descriptors(jnp.asarray(a), jnp.asarray(b),
                                  valid_b=jnp.asarray(vb0))
    it, ot = td.match_descriptors(_t(a), _t(b), valid_b=_t(vb0))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert not ot.any() and not np.asarray(oj).any()


@pytest.mark.parametrize("mono", [False, True])
def test_bow_describe_matches_jax(jframes, vocab, mono):
    # uv, d and valid equal; desc and xyz within 1e-5 abs; words equal on
    # >= 99% of the valid rows (a near-tie in the 10,000-way argmax can
    # flip a word between the frameworks' matmul orders); the rate printed
    jv = jnp.asarray(vocab)
    tv = _t(vocab)
    same = total = 0
    for f in jframes:
        disp = np.zeros_like(f["disp_gt"]) if mono else f["disp_gt"]
        pj = np.asarray(jpr._describe_device(
            jnp.asarray(f["left"]), jnp.asarray(disp), jv, CAM_PARAMS, mono))
        pt = td.bow_describe(_t(f["left"]), _t(disp), tv, CAM_PARAMS,
                             mono=mono).numpy()
        assert pt.shape == pj.shape == (td.BOW_KEYPOINTS, td.BOW_COLS)
        wj, dj, uvdj, xyzj, vj = jpr.unpack_bow(pj)
        wt, dt, uvdt, xyzt, vt = tpr.unpack_bow(pt)
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(uvdt, uvdj)
        assert vj.sum() > 100
        np.testing.assert_allclose(dt[vj], dj[vj], atol=1e-5, rtol=0)
        np.testing.assert_allclose(xyzt[vj], xyzj[vj], atol=1e-5, rtol=0)
        same += int((wt[vj] == wj[vj]).sum())
        total += int(vj.sum())
    rate = same / total
    print(f"bow_describe mono={mono}: words equal on {same}/{total} valid "
          f"rows ({100 * rate:.2f}%)")
    assert rate >= 0.99


# -- port-only mirrors of tests/test_placerec.py::TestDescriptors ---------- #

@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(CAM, n_frames=30, step=0.02, device="cpu")


def test_normalized(seq):
    dx, dy = sobel_xy(seq.frame(0)["left"])
    uv = torch.tensor([[64.0, 64.0], [128.0, 96.0], [200.0, 150.0]])
    desc, ok = td.compute_descriptors(dx, dy, uv)
    assert desc.shape == (3, 128) and bool(ok.all())
    np.testing.assert_allclose(torch.linalg.norm(desc, dim=1).numpy(), 1.0,
                               atol=1e-4)


def test_same_patch_matches_self(seq):
    dx, dy = sobel_xy(seq.frame(0)["left"])
    uv = torch.tensor([[64.0, 64.0], [130.0, 100.0], [200.0, 150.0],
                       [90.0, 140.0]])
    desc, _ = td.compute_descriptors(dx, dy, uv)
    idx, ok = td.match_descriptors(desc, desc, ratio=0.9)
    np.testing.assert_array_equal(idx.numpy(), np.arange(4))


def test_descriptors_stable_across_frames(seq):
    """The same 3-D point seen in neighbouring frames has a similar
    descriptor."""
    f0, f1 = seq.frame(0), seq.frame(1)
    dx0, dy0 = sobel_xy(f0["left"])
    dx1, dy1 = sobel_xy(f1["left"])
    uv0 = torch.tensor([[80.0, 80.0], [150.0, 100.0], [190.0, 140.0]])
    d = torch.stack([f0["disp_gt"][int(v), int(u)] for u, v in uv0.tolist()])
    xyz0 = CAM.unmap_uvu(torch.stack([uv0[:, 0], uv0[:, 1], uv0[:, 0] - d],
                                     dim=-1))
    T_10 = f1["T_cw_gt"] @ f0["T_cw_gt"].inverse()
    uv1 = CAM.map_uvu(T_10.apply(xyz0))[:, :2]
    d0, _ = td.compute_descriptors(dx0, dy0, uv0)
    d1, _ = td.compute_descriptors(dx1, dy1, uv1)
    sims = torch.sum(d0 * d1, dim=1).numpy()
    assert (sims > 0.8).all(), sims

"""Module parity: the PyTorch port (scavislam_tpu_torch) against its JAX
twin (scavislam_tpu) on the same numpy inputs, on the CPU.

Each test states its tolerance and why. Float32 throughout; where the two
libraries evaluate the same expression in another order (XLA fuses
multiply-adds, BLAS sums in blocks) the tolerance is a few ulps of the
values compared.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scavislam_tpu.core import lie as jlie
from scavislam_tpu.core.camera import StereoCamera as JCam
from scavislam_tpu.io import synthetic as jsyn
from scavislam_tpu.models import dense_tracker as jdt
from scavislam_tpu.models import frontend_step as jfs
from scavislam_tpu.models import matcher as jmatch
from scavislam_tpu.models import pose_optimizer as jpo
from scavislam_tpu.ops import fast as jfast
from scavislam_tpu.ops import image as jimg
from scavislam_tpu.ops import stereo as jstereo
from scavislam_tpu_torch.core import lie as tlie
from scavislam_tpu_torch.core.camera import StereoCamera as TCam
from scavislam_tpu_torch.io import synthetic as tsyn
from scavislam_tpu_torch.models import dense_tracker as tdt
from scavislam_tpu_torch.models import frontend_step as tfs
from scavislam_tpu_torch.models import matcher as tmatch
from scavislam_tpu_torch.models import pose_optimizer as tpo
from scavislam_tpu_torch.ops import fast as tfast
from scavislam_tpu_torch.ops import image as timg
from scavislam_tpu_torch.ops import stereo as tstereo

# the 256x192 camera the JAX VO tests use
J_CAM = JCam.create(195.0, (127.0, 95.0), (256, 192), 0.12)
T_CAM = TCam.create(195.0, (127.0, 95.0), (256, 192), 0.12)
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


def _t(x):
    return torch.as_tensor(np.array(x))


def _n(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@pytest.fixture(scope="module")
def frames():
    """Two consecutive forward-arc frames from the JAX renderer (numpy)."""
    seq = jsyn.SyntheticSequence(J_CAM, n_frames=2)
    out = []
    for i in range(2):
        f = seq.frame(i)
        out.append({k: np.asarray(f[k]) for k in ("left", "right", "disp_gt")})
    return out


# -- core.lie ------------------------------------------------------------------

class TestLie:
    @staticmethod
    def _xi(seed):
        rng = np.random.default_rng(seed)
        xi = rng.normal(size=(64, 6)).astype(np.float32)
        # angles from tiny (Taylor branch) through 3.1 rad (near pi)
        ang = np.concatenate([np.geomspace(1e-6, 0.19, 24),
                              np.linspace(0.25, 3.1, 40)]).astype(np.float32)
        ax = xi[:, 3:] / np.linalg.norm(xi[:, 3:], axis=1, keepdims=True)
        xi[:, 3:] = ax * ang[:, None]
        return xi

    @pytest.mark.parametrize("seed", [0, 1])
    def test_se3_exp_matches(self, seed):
        # f32 sin/cos of two libraries: a few ulps on O(1) entries
        xi = self._xi(seed)
        Tj = jlie.SE3.exp(jnp.asarray(xi))
        Tt = tlie.SE3.exp(_t(xi))
        np.testing.assert_allclose(_n(Tt.R), np.asarray(Tj.R), atol=2e-6)
        np.testing.assert_allclose(_n(Tt.t), np.asarray(Tj.t), atol=1e-5)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_se3_log_matches(self, seed):
        # log recovers the tangent; near pi the axis comes from a square
        # root of (diag - cos)/(1 - cos), which amplifies ulps: 2e-4 there,
        # 1e-5 elsewhere
        xi = self._xi(seed)
        T = jlie.SE3.exp(jnp.asarray(xi))
        Rn, tn = np.asarray(T.R), np.asarray(T.t)
        lj = np.asarray(jlie.SE3(jnp.asarray(Rn), jnp.asarray(tn)).log())
        lt = _n(tlie.SE3(_t(Rn), _t(tn)).log())
        ang = np.linalg.norm(xi[:, 3:], axis=1)
        near_pi = ang > 3.0
        np.testing.assert_allclose(lt[~near_pi], lj[~near_pi], atol=1e-5)
        np.testing.assert_allclose(lt[near_pi], lj[near_pi], atol=2e-4)

    def test_compose_inverse_matches(self):
        # pure products and transposes: same f32 ops up to summation order
        xi = self._xi(2)
        A = jlie.SE3.exp(jnp.asarray(xi))
        B = jlie.SE3.exp(jnp.asarray(xi[::-1].copy()))
        Aj, Bj = (np.asarray(A.R), np.asarray(A.t)), (np.asarray(B.R), np.asarray(B.t))
        Cj = jlie.SE3(*map(jnp.asarray, Aj)) @ jlie.SE3(*map(jnp.asarray, Bj)).inverse()
        Ct = tlie.SE3(*map(_t, Aj)) @ tlie.SE3(*map(_t, Bj)).inverse()
        np.testing.assert_allclose(_n(Ct.R), np.asarray(Cj.R), atol=1e-6)
        np.testing.assert_allclose(_n(Ct.t), np.asarray(Cj.t), atol=1e-5)


# -- ops.image -------------------------------------------------------------------

class TestImage:
    def test_pyramid_and_sobel_match(self, frames):
        # rolled shifted adds in the twin's order; XLA may fuse a multiply
        # into the add (one rounding fewer): 1e-6 on [0, 1] images
        img = frames[0]["left"]
        pj = jimg.build_pyramid(jnp.asarray(img), 3)
        pt = timg.build_pyramid(_t(img), 3)
        for a, b in zip(pj, pt):
            assert a.shape == tuple(b.shape)
            np.testing.assert_allclose(_n(b), np.asarray(a), atol=1e-6)
            (dxj, dyj), (dxt, dyt) = jimg.sobel_xy(a), timg.sobel_xy(_t(np.asarray(a)))
            np.testing.assert_allclose(_n(dxt), np.asarray(dxj), atol=1e-6)
            np.testing.assert_allclose(_n(dyt), np.asarray(dyj), atol=1e-6)
        bj = jimg.binomial3(jnp.asarray(img))
        np.testing.assert_allclose(_n(timg.binomial3(_t(img))), np.asarray(bj),
                                   atol=1e-6)

    def test_bilinear_and_nearest_match(self, frames):
        # bilinear: the same four taps and weights, 1e-6; nearest: exact
        img = frames[0]["left"]
        rng = np.random.default_rng(3)
        uv = rng.uniform([-3.0, -3.0], [259.0, 195.0], size=(4000, 2)).astype(np.float32)
        uv[:10] = [[0, 0], [255, 191], [255, 0], [0, 191], [254.5, 190.5],
                   [-0.5, 3], [3, -0.5], [255.5, 3], [3, 191.5], [127.5, 95.5]]
        vj, okj = jimg.bilinear_sample(jnp.asarray(img), jnp.asarray(uv))
        vt, okt = timg.bilinear_sample(_t(img), _t(uv))
        np.testing.assert_array_equal(_n(okt), np.asarray(okj))
        np.testing.assert_allclose(_n(vt), np.asarray(vj), atol=1e-6)
        nj, nokj = jimg.nearest_sample(jnp.asarray(img), jnp.asarray(uv))
        nt, nokt = timg.nearest_sample(_t(img), _t(uv))
        np.testing.assert_array_equal(_n(nokt), np.asarray(nokj))
        np.testing.assert_array_equal(_n(nt), np.asarray(nj))


# -- ops.stereo (the cost-volume twin, stereo method 1) --------------------------

def test_stereo_twin_matches_jax(frames):
    # same prefilter, cost volume and prefix-sum box filter; summation order
    # differs in the last bit, which can flip an argmin between two equal
    # costs: >= 99.9% of pixels agree on validity and, where both are
    # valid, within 1e-3 px
    left, right = frames[0]["left"], frames[0]["right"]
    dj = np.asarray(jstereo.block_matching_disparity(
        jnp.asarray(left), jnp.asarray(right), num_disp=64, radius=5))
    dt = _n(tstereo.block_matching_disparity(_t(left), _t(right),
                                             num_disp=64, radius=5))
    vj, vt = dj > 0, dt > 0
    assert vj.mean() > 0.3
    assert (vj == vt).mean() >= 0.999, (vj == vt).mean()
    both = vj & vt
    assert (np.abs(dj[both] - dt[both]) <= 1e-3).mean() >= 0.999


# -- ops.fast ------------------------------------------------------------------------

@pytest.mark.parametrize("level", [0, 2])
def test_fast_corners_match(frames, level):
    # the FAST test and score are threshold comparisons and sums of 16
    # terms in ring order: corner sets equal; scores within 1e-6
    pyr = jimg.build_pyramid(jnp.asarray(frames[0]["left"]), 3)
    img = np.asarray(jimg.binomial3(pyr[level]))
    h, w = img.shape
    cy, cx = max(h // 16, 4), max(w // 16, 4)
    uvj, sj, vj = jfast.detect_corners_grid(jnp.asarray(img), 10.0 / 255.0, cy, cx, 4)
    uvt, st, vt = tfast.detect_corners_grid(_t(img), 10.0 / 255.0, cy, cx, 4)
    assert np.asarray(vj).sum() > 50
    np.testing.assert_array_equal(_n(vt), np.asarray(vj))
    np.testing.assert_array_equal(_n(uvt)[_n(vt)], np.asarray(uvj)[np.asarray(vj)])
    np.testing.assert_allclose(_n(st), np.asarray(sj), atol=1e-6)


# -- models.dense_tracker ----------------------------------------------------------

def test_dense_lm_level_ic_matches(frames):
    # the cloud of frame 0 tracked into frame 1 at every level: the LM takes
    # the same accept/reject path; poses agree to 1e-4 (f32 6x6 solves on
    # H summed over ~10^4 points in another order)
    cam_params_j = tuple((c.focal, c.pp[0], c.pp[1], c.baseline)
                         for c in (J_CAM.scale_level(l) for l in range(3)))
    cams_t = [T_CAM.scale_level(l) for l in range(3)]
    cam_params_t = tuple((c.focal, c.pp[0], c.pp[1], c.baseline) for c in cams_t)
    pj0 = jimg.build_pyramid(jnp.asarray(frames[0]["left"]), 3)
    dxs, dys = zip(*[jimg.sobel_xy(p) for p in pj0])
    disp = jnp.asarray(frames[0]["disp_gt"])
    clouds, valids, intens, Js = jfs._cloud_state(
        pj0, disp, jnp.eye(3), jnp.zeros(3), cam_params_j, 3, dxs, dys)
    ct, vt, it, Jt = tfs._cloud_state(
        tuple(_t(np.asarray(p)) for p in pj0), _t(frames[0]["disp_gt"]),
        torch.eye(3), torch.zeros(3), cam_params_t, 3,
        tuple(_t(np.asarray(d)) for d in dxs), tuple(_t(np.asarray(d)) for d in dys))
    for a, b in zip(clouds + Js, ct + Jt):
        np.testing.assert_allclose(_n(b), np.asarray(a), rtol=1e-5, atol=1e-5)
    pj1 = jimg.build_pyramid(jnp.asarray(frames[1]["left"]), 3)
    Rj, tj = jnp.eye(3), jnp.zeros(3)
    Rt, tt = torch.eye(3), torch.zeros(3)
    for level in (2, 1, 0):
        jc = J_CAM.scale_level(level)
        lm = jax.jit(lambda img, c, i, J, v, R, t, jc=jc:
                     jdt._lm_level_ic(jc, img, c, i, J, v, R, t))
        Rj, tj, chij, itj = lm(pj1[level], clouds[level], intens[level],
                               Js[level], valids[level], Rj, tj)
        tc = cams_t[level]
        Rt, tt, chit, itt = tdt._lm_level_ic(
            tc, _t(np.asarray(pj1[level])), ct[level], it[level], Jt[level],
            vt[level], Rt, tt)
        assert itt == int(itj)
        np.testing.assert_allclose(_n(Rt), np.asarray(Rj), atol=1e-4)
        np.testing.assert_allclose(_n(tt), np.asarray(tj), atol=1e-4)
        np.testing.assert_allclose(float(chit), float(chij), rtol=1e-3)
    assert float(np.linalg.norm(np.asarray(tj))) > 1e-3  # it moved


# -- models.pose_optimizer -----------------------------------------------------------

def test_motion_only_ba_matches():
    # robust LM on 300 noisy stereo observations with 10% outliers and some
    # invalid rows: same pose to 1e-4, same inlier set, chi2 within 1e-3
    rng = np.random.default_rng(7)
    n = 300
    xyz = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(2, 8, n)], -1).astype(np.float32)
    T_true = jlie.SE3.exp(jnp.asarray([0.05, -0.02, 0.1, 0.01, -0.03, 0.02], jnp.float32))
    cam = J_CAM
    obs = np.asarray(cam.map_uvu(T_true.apply(jnp.asarray(xyz))))
    obs = obs + rng.normal(0, 0.3, obs.shape).astype(np.float32)
    obs[::10] += rng.uniform(-20, 20, obs[::10].shape).astype(np.float32)
    valid = rng.uniform(size=n) > 0.05
    weights = (0.25 ** rng.integers(0, 3, n)).astype(np.float32)
    T0 = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    rj = jpo.motion_only_ba_jit(
        cam, jlie.SE3(*map(jnp.asarray, T0)), jnp.asarray(xyz), jnp.asarray(obs),
        jnp.asarray(weights), jnp.asarray(valid))
    rt = tpo.motion_only_ba(T_CAM, tlie.SE3(*map(_t, T0)), _t(xyz), _t(obs),
                            _t(weights), _t(valid))
    np.testing.assert_allclose(_n(rt.T.R), np.asarray(rj.T.R), atol=1e-4)
    np.testing.assert_allclose(_n(rt.T.t), np.asarray(rj.T.t), atol=1e-4)
    np.testing.assert_allclose(float(rt.chi2), float(rj.chi2), rtol=1e-3)
    np.testing.assert_array_equal(_n(rt.inlier_mask), np.asarray(rj.inlier_mask))
    np.testing.assert_allclose(_n(rt.T.t), np.asarray(T_true.t), atol=0.05)


# -- models.matcher ------------------------------------------------------------------

def test_warp_from_source_matches():
    # the exact gather stands in for the twin's tap-packed one: the same
    # four taps and weights, values to 1e-6, masks equal
    rng = np.random.default_rng(11)
    n = 200
    src = rng.uniform(0, 1, (n, 16, 16)).astype(np.float32)
    A = (np.eye(2)[None] + rng.normal(0, 0.3, (n, 2, 2))).astype(np.float32)
    A[:5] *= 2.5  # some warps leave the source patch
    vj, okj = jmatch._warp_from_source(jnp.asarray(src), jnp.asarray(A))
    vt, okt = tmatch._warp_from_source(_t(src), _t(A))
    assert 0 < np.asarray(okj).sum() < n
    np.testing.assert_array_equal(_n(okt), np.asarray(okj))
    np.testing.assert_allclose(_n(vt), np.asarray(vj), atol=1e-6)


# -- io.synthetic --------------------------------------------------------------------

@pytest.mark.parametrize("kind,i", [("forward_arc", 0), ("forward_arc", 5),
                                    ("wander", 3)])
def test_renderer_matches(kind, i):
    # Geometry (disparity) agrees to f32 rounding everywhere: 1e-5. The
    # texture's lattice hash fract(sin(x) * 43758.5453) turns a last-bit
    # difference of sin() or of a fused multiply-add into a different
    # lattice value, and XLA's f32 sin differs from PyTorch's in the last
    # bit on a few percent of arguments; so the images are held to 1e-5 on
    # the majority of pixels (measured ~66% at 256x192) and to the texture's
    # amplitude elsewhere, with the same mean brightness.
    planes_j = jsyn.closed_box() if kind == "wander" else None
    planes_t = tsyn.closed_box() if kind == "wander" else None
    step = 0.06 if kind == "wander" else 0.02
    a = jsyn.SyntheticSequence(J_CAM, 8, kind, planes_j, step).frame(i)
    b = tsyn.SyntheticSequence(T_CAM, 8, kind, planes_t, step,
                               device=CPU).frame(i)
    np.testing.assert_allclose(_n(b["disp_gt"]), np.asarray(a["disp_gt"]), atol=1e-5)
    np.testing.assert_allclose(_n(b["T_cw_gt"].t), np.asarray(a["T_cw_gt"].t), atol=1e-6)
    for k in ("left", "right"):
        x, y = np.asarray(a[k]), _n(b[k])
        d = np.abs(x - y)
        assert (d <= 1e-5).mean() > 0.55, (k, (d <= 1e-5).mean())
        assert d.max() < 0.35
        assert abs(x.mean() - y.mean()) < 5e-3


# -- packaging -------------------------------------------------------------------------

def test_package_imports_without_jax():
    # the port must run where JAX is not installed
    code = (
        "import sys\n"
        "import scavislam_tpu_torch, scavislam_tpu_torch.interop\n"
        "from scavislam_tpu_torch.models import frontend, frontend_step\n"
        "from scavislam_tpu_torch.ops import stereo_bm, stereo, fast, image\n"
        "from scavislam_tpu_torch.io import synthetic\n"
        "from scavislam_tpu_torch.utils import config, perfmon\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('scavislam_tpu.') or m == 'scavislam_tpu']\n"
        "assert not bad, bad\n"
    )
    root = Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=120)
    for path in (root / "scavislam_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax",
                                     "import scavislam_tpu ", "from scavislam_tpu.",
                                     "from scavislam_tpu ")), (path, line)

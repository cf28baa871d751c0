"""The block-matching CUDA kernels' decomposition, emulated on the CPU.

``csrc/stereo_bm.cu`` splits the work the plain version does as one
(D, H, W) cost volume: kernel A owns a tile of ``stereo_bm.tile_shape(D)``
output pixels, stages the tile's rows with a halo (zeros outside the
image), walks d computing each cost once from separable window sums, keeps
the left view online in d, and merges the right view into 64-bit keys
``(float bits of cost << 32) | d`` by minimum across tiles; kernel B
applies the left-right check and the border rows. The CUDA code runs only
on a card (``tests/test_torch_cuda.py``); here the same decomposition,
written in PyTorch with the kernel's order of operations, must give the
plain version's output bit for bit: the tile borders, the online runner-up,
the ties and the BIG-only columns are checked nowhere else off the card.
"""

import numpy as np
import pytest
import torch

from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.io.synthetic import SyntheticSequence, closed_box
from scavislam_tpu_torch.ops import stereo_bm
from scavislam_tpu_torch.ops.image import binomial3
from scavislam_tpu_torch.ops.stereo import _sobel_x_prefilter

BIG = stereo_bm.BIG
NONE = torch.iinfo(torch.int64).max  # the kernel's ~0 key: no candidate
CAM = StereoCamera.create(195.0, (127.0, 95.0), (256, 192), 0.35)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (pytest-xdist may run one
    process per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _box_h(x, n_out):
    """Horizontal window sums of the staged diffs, in the order u, u-1,
    u+1, ..., u-r, u+r, for the n_out tile columns."""
    r = stereo_bm.KERNEL_RADIUS
    h = x[..., r:r + n_out]
    for k in range(1, r + 1):
        h = h + x[..., r - k:r - k + n_out]
        h = h + x[..., r + k:r + k + n_out]
    return h


def _box_v(h, n_out):
    """Vertical sums, top row first (0 + h_top == h_top: h >= +0)."""
    c = h[..., 0:n_out, :]
    for k in range(1, 2 * stereo_bm.KERNEL_RADIUS + 1):
        c = c + h[..., k:k + n_out, :]
    return c


def emulate(lf, rf, num_disp, uniq=1.10, tex_thr=0.01):
    """Kernel A over every tile at once (leading dims: strip, column tile),
    then kernel B. Returns f32 (H, W) disparity, -1 invalid."""
    r = stereo_bm.KERNEL_RADIUS
    D = num_disp
    T, Wt = stereo_bm.tile_shape(D)
    H, W = lf.shape
    strips = -(-(H - 2 * r) // T)
    cols = -(-W // Wt)

    # staging: zeros outside the image; a tile's L halo starts at column
    # c0 - r, its R halo D - 1 columns further left
    rows = strips * T + 2 * r
    Lp = torch.zeros(rows, cols * Wt + 2 * r)
    Lp[:H, r:r + W] = lf
    Rp = torch.zeros(rows, cols * Wt + 2 * r + D - 1)
    Rp[:H, r + D - 1:r + D - 1 + W] = rf
    Lt = Lp.unfold(0, T + 2 * r, T).unfold(1, Wt + 2 * r, Wt)
    Rt = Rp.unfold(0, T + 2 * r, T).unfold(1, Wt + 2 * r + D - 1, Wt)
    x = (torch.arange(cols)[:, None] * Wt - r
         + torch.arange(Wt + 2 * r)[None, :])[None, :, None, :]

    shape = (strips, cols, T, Wt)
    best = torch.zeros(shape, dtype=torch.int64)
    cmin, cm, cp, c2, prev, pm1, pm2 = (torch.full(shape, BIG)
                                        for _ in range(7))
    rc = torch.full((strips, cols, T, Wt + D - 1), BIG)
    rd = torch.zeros(rc.shape, dtype=torch.int64)
    for d in range(D):
        Rd = Rt[..., D - 1 - d:D - 1 - d + Wt + 2 * r]
        diff = torch.where((x >= d) & (x < W), torch.abs(Lt - Rd),
                           torch.full_like(Lt, BIG))
        c = _box_v(_box_h(diff, Wt), T)
        # left view, online: a new best restarts the runner-up from the
        # prefix minimum up to d - 2
        nb = c < cmin
        nxt = ~nb & (best + 1 == d)
        far = ~nb & (best + 1 < d)
        cm = torch.where(nb, prev, cm)
        cp = torch.where(nb, torch.full_like(c, BIG), torch.where(nxt, c, cp))
        c2 = torch.where(nb, pm2, torch.where(far, torch.minimum(c2, c), c2))
        best = torch.where(nb, torch.full_like(best, d), best)
        cmin = torch.where(nb, c, cmin)
        pm2, pm1, prev = pm1, torch.minimum(pm1, c), c
        # right view: cost (t, u, d) is a candidate of right pixel u - d
        win = slice(D - 1 - d, D - 1 - d + Wt)
        upd = c < rc[..., win]
        rc[..., win] = torch.where(upd, c, rc[..., win])
        rd[..., win] = torch.where(upd, torch.full_like(rd[..., win], d),
                                   rd[..., win])

    tdiff = torch.where((x >= 0) & (x < W), torch.abs(Lt - 0.0),
                        torch.full_like(Lt, BIG))
    tex = _box_v(_box_h(tdiff, Wt), T)
    denom = cm + cp - 2.0 * cmin
    interior = (best > 0) & (best < D - 1) & (cm < BIG) & (cp < BIG)
    delta = torch.where(interior & (denom > 1e-9),
                        0.5 * (cm - cp) / torch.clamp(denom, min=1e-9),
                        torch.zeros_like(denom))
    delta = torch.clamp(delta, -0.5, 0.5)
    full = torch.full_like(tex, 121.0)
    ok = ((cmin < 1e4) & (cmin * uniq <= c2) & (tex / full > tex_thr)
          & (best > 0))
    tile_disp = torch.where(ok, best.to(torch.float32) + delta,
                            torch.full_like(delta, -1.0))

    # scatter the tiles' pixels (rows < H - r, columns < W)
    v = (r + torch.arange(strips)[:, None, None, None] * T
         + torch.arange(T)[None, None, :, None])
    u = (torch.arange(cols)[None, :, None, None] * Wt
         + torch.arange(Wt)[None, None, None, :])
    v, u = torch.broadcast_tensors(v, u)
    keep = (v < H - r) & (u < W)
    disp = torch.full((H, W), -1.0)
    best_img = torch.zeros((H, W), dtype=torch.int64)
    disp[v[keep], u[keep]] = tile_disp[keep]
    best_img[v[keep], u[keep]] = best[keep]

    # right-view keys, merged across tiles by minimum
    vk = (r + torch.arange(strips)[:, None, None, None] * T
          + torch.arange(T)[None, None, :, None])
    ur = (torch.arange(cols)[None, :, None, None] * Wt - (D - 1)
          + torch.arange(Wt + D - 1)[None, None, None, :])
    vk, ur = torch.broadcast_tensors(vk, ur)
    has = (vk < H - r) & (ur >= 0) & (ur < W) & (rc < BIG)
    keys = (rc.view(torch.int32).to(torch.int64) << 32) | rd
    key_img = torch.full((H * W,), NONE, dtype=torch.int64)
    key_img.scatter_reduce_(0, (vk * W + ur)[has], keys[has], "amin")
    key_img = key_img.view(H, W)

    # kernel B: the left-right check and the border rows
    col = torch.arange(W)[None, :]
    ridx = torch.remainder(col - best_img, W)
    key = torch.gather(key_img, 1, ridx)
    bestr = torch.where(key == NONE, torch.zeros_like(key), key & 0xFFFFFFFF)
    lr_ok = torch.abs(best_img - bestr) <= 1
    row = torch.arange(H)[:, None]
    inside = (row >= r) & (row < H - r)
    return torch.where(inside & (disp >= 0) & lr_ok, disp,
                       torch.full_like(disp, -1.0))


@pytest.fixture(scope="module")
def rendered():
    """Frame 0 of the closed box at 256x192, prefiltered as the frontend
    feeds the kernel (binomial3, then Sobel-x clipped to +-0.5)."""
    f = SyntheticSequence(CAM, n_frames=1, kind="wander", planes=closed_box(),
                          step=0.06, device=CPU).frame(0)
    return (_sobel_x_prefilter(binomial3(f["left"])),
            _sobel_x_prefilter(binomial3(f["right"])))


@pytest.mark.parametrize("num_disp", [16, 64, 128])
def test_tiling_equals_plain(rendered, num_disp):
    lf, rf = rendered
    de = emulate(lf, rf, num_disp)
    dp = stereo_bm.bm_plain(lf, rf, num_disp, stereo_bm.KERNEL_RADIUS)
    assert (dp > 0).float().mean() > 0.2
    assert torch.equal(de, dp)


@pytest.mark.parametrize("shape", [(190, 256), (192, 250), (190, 237)])
def test_tiling_equals_plain_ragged(rendered, shape):
    # H - 2r not a multiple of T, W not a multiple of Wt: partial tiles
    h, w = shape
    T, Wt = stereo_bm.tile_shape(64)
    assert (h - 10) % T or w % Wt
    lf, rf = (x[:h, :w].contiguous() for x in rendered)
    de = emulate(lf, rf, 64)
    assert torch.equal(de, stereo_bm.bm_plain(lf, rf, 64, 5))


def test_tiling_equals_plain_on_ties():
    # a few exact levels (multiples of 1/4: every window sum is exact, so
    # costs tie often), one region periodic in x (exact ties between d and
    # d + 10 in both views) and a true shift of 7 columns; the left edge
    # has BIG-only columns (u < r) and u < d candidates at every d
    rng = np.random.default_rng(3)
    h, w = 70, 150
    base = rng.integers(-2, 3, size=(h, w + 7)).astype(np.float32) * 0.25
    base[20:50, 40:110] = np.tile(base[20:50, 40:50], (1, 7))
    lf = torch.as_tensor(base[:, :w].copy())
    rf = torch.as_tensor(base[:, 7:7 + w].copy())
    # some disagreement outside the periodic rows, so runner-ups are not
    # all 0; inside them the match at d = 7 ties exactly with d = 17, 27
    rf[:20, ::13] = 0.0
    rf[50:, ::13] = 0.0
    for num_disp in (16, 32):
        dp = stereo_bm.bm_plain(lf, rf, num_disp, 5)
        assert ((dp > 0).sum() > 100) and ((dp == -1).sum() > 100)
        assert torch.equal(emulate(lf, rf, num_disp), dp)


def test_tile_shape_and_budget():
    # every supported count has a tile and fits a block's shared memory;
    # others raise
    for num_disp in stereo_bm.SUPPORTED_NUM_DISP:
        T, Wt = stereo_bm.tile_shape(num_disp)
        assert T >= 16 and Wt % 32 == 0
        assert stereo_bm._smem_bytes(num_disp) <= stereo_bm._SMEM_LIMIT
    assert stereo_bm._smem_bytes(64) == 34936
    with pytest.raises(ValueError, match="num_disp"):
        stereo_bm.tile_shape(24)

"""Block-matching stereo: the hand-written Hopper kernel and its plain twin.

Replaces the Pallas TPU kernel ``scavislam_tpu/ops/stereo_pallas.py::
_bm_kernel`` through both of its callers: ``block_matching_disparity_pallas``
(one image, stereo method 2 — the default) and
``block_matching_disparity_pallas_batched`` (B streams in one launch, the
multistream step's stereo). The CUDA C++ source is ``csrc/stereo_bm.cu``;
its header says what bounds it on the H100 and how the design meets it. It
is compiled for ``sm_90a`` with nvcc at first use, once per disparity
count, into ``build/kernels/`` and bound with ctypes; it launches on
PyTorch's current stream.

One wrapper call is two device kernels, after the scratch's fill:
- kernel A computes each cost once, for a tile of ``tile_shape(D)`` =
  (T, Wt) output pixels per thread block: separable window sums in the
  plain version's order, the left view online in d, and the right view
  from the same costs, merged across tiles into a uint64 (B, H, W) key
  scratch (``(float bits of cost << 32) | d``, filled with ~0 first) by
  atomic minimum;
- kernel B applies the left-right check and the border rows.
The wrapper allocates the output, the int32 best-disparity plane and the
key scratch; the kernels allocate nothing. The single-image entry is B = 1
of the batched grid, so each stream's result is bit for bit the
single-image result, whatever B is. The kernel is built for the 11x11
window (``radius`` 5); the plain version takes any radius.

Semantics of the TPU kernel, kept exactly (both versions here):
- SAD over an 11x11 window of the Sobel-x prefiltered images; a column
  with u < d, or a tap outside the image, contributes BIG = 1e9; a pixel is
  valid only if its best cost is < 1e4;
- argmin with strict < (ties keep the smallest d); runner-up excludes
  |d - best| <= 1, uniqueness ``cmin * 1.10 <= c2``;
- texture: box sum of |lf| / 121 > 0.01;
- parabola subpixel only where both neighbours are < BIG, clipped to +-0.5;
- left-right check |best - bestR(u - best)| <= 1 against the right-view
  winner map (wrapped index, as the TPU kernel's circular roll);
- the first and last `radius` rows are invalid. Any H is accepted.

Dispatch: ``block_matching_disparity_bm`` (H, W) and
``block_matching_disparity_bm_batched`` (B, H, W) run the plain PyTorch
version for a tensor on the CPU and the CUDA kernels for a CUDA tensor;
there is no fallback between them. Each has its own ``.launches`` counter,
which counts wrapper calls that launch the kernels (one per frame, one per
tick), not device kernels. A call made while its thread captures a CUDA
graph records the kernels without launching them: it is noted in
``CAPTURED`` instead, and each replay of the graph counts it
(``models/step_graph.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from scavislam_tpu_torch.ops.stereo import _sobel_x_prefilter

BIG = 1.0e9
SUPPORTED_NUM_DISP = (16, 32, 48, 64, 80, 96, 112, 128)
KERNEL_RADIUS = 5  # the CUDA kernel's window is 11x11, fixed at compile time
_TILE = (16, 32)  # output rows, columns per block of the cost kernel
_SMEM_LIMIT = 232448  # bytes of dynamic shared memory one block may use


def tile_shape(num_disp: int) -> tuple[int, int]:
    """(T, Wt): the output rows and columns one thread block of the cost
    kernel owns at `num_disp` disparities (the same for every supported
    count). The block stages T + 2r input rows and computes each window
    sum of its tile once."""
    if num_disp not in SUPPORTED_NUM_DISP:
        raise ValueError(f"num_disp {num_disp} not in {SUPPORTED_NUM_DISP}")
    return _TILE


def _smem_bytes(num_disp: int) -> int:
    """Dynamic shared memory of one cost-kernel block (the source's
    ``Layout<D>``): two h planes with a 4-column pad, the staged L and R
    rows, and the right view's (cost, d) table."""
    t, wt = tile_shape(num_disp)
    rows = t + 2 * KERNEL_RADIUS
    lw = wt + 2 * KERNEL_RADIUS
    words = (2 * rows * (wt + 4) + rows * lw + rows * (lw + num_disp - 1)
             + 2 * t * (wt + num_disp - 1))
    return 4 * words


_REPO = Path(__file__).resolve().parents[2]
_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "stereo_bm.cu"
BUILD_DIR = _REPO / "build" / "kernels"


# -- plain PyTorch version ---------------------------------------------------

def _shift_cols(x: torch.Tensor, k: int, fill: float) -> torch.Tensor:
    """Column j reads j - k (k > 0: from the left; k < 0: from the right),
    `fill` where that column is outside the image."""
    pad = torch.full((*x.shape[:-1], abs(k)), fill, dtype=x.dtype,
                     device=x.device)
    if k > 0:
        return torch.cat([pad, x[..., :-k]], dim=-1)
    return torch.cat([x[..., -k:], pad], dim=-1)


def _box_h(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Horizontal (2r+1)-tap sum in the kernel's order u, u-1, u+1, u-2, ...
    with BIG for taps outside the image."""
    acc = x
    for k in range(1, radius + 1):
        acc = acc + _shift_cols(x, k, BIG)
        acc = acc + _shift_cols(x, -k, BIG)
    return acc


def _box_v(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Vertical (2r+1)-row sum, top row first (rows outside the image read
    0; those output rows are invalidated anyway)."""
    h = x.shape[-2]
    xp = torch.nn.functional.pad(x, (0, 0, radius, radius))
    acc = torch.zeros_like(x)
    for k in range(2 * radius + 1):
        acc = acc + xp[..., k:k + h, :]
    return acc


def bm_plain(lf: torch.Tensor, rf: torch.Tensor, num_disp: int = 64,
             radius: int = 5, uniqueness_ratio: float = 1.10,
             texture_threshold: float = 0.01) -> torch.Tensor:
    """Plain PyTorch version of the kernel on prefiltered images, as a
    (D, H, W) cost-volume program. Bit-for-bit the kernel's arithmetic."""
    h, w = lf.shape
    dev = lf.device
    D = num_disp
    col = torch.arange(w, device=dev)
    dd = torch.arange(D, device=dev)
    src = col[None, :] - dd[:, None]  # (D, W)
    rfd = rf[:, src.clamp(min=0)].permute(1, 0, 2)  # (D, H, W)
    diff = torch.where((src >= 0)[:, None, :], torch.abs(lf[None] - rfd),
                       torch.full_like(rfd, BIG))
    cost = _box_v(_box_h(diff, radius), radius)

    big = torch.full((h, w), BIG, dtype=lf.dtype, device=dev)
    best = torch.argmin(cost, dim=0)
    cmin = torch.gather(cost, 0, best[None])[0]
    has = cmin < BIG  # strict-< scan from BIG: no update leaves (0, BIG)
    best = torch.where(has, best, torch.zeros_like(best))
    cmin = torch.where(has, cmin, big)

    far = torch.abs(dd[:, None, None] - best[None]) > 1
    c2 = torch.where(far, cost, torch.full_like(cost, float("inf"))).amin(0)
    c2 = torch.minimum(c2, big)
    c_m = torch.where(
        best >= 1, torch.gather(cost, 0, (best - 1).clamp(min=0)[None])[0], big)
    c_p = torch.where(
        best <= D - 2,
        torch.gather(cost, 0, (best + 1).clamp(max=D - 1)[None])[0], big)

    tex = _box_v(_box_h(torch.abs(lf), radius), radius)
    # a tensor divisor: on a CUDA tensor PyTorch divides by a Python scalar
    # as a multiply by its reciprocal, one ulp off the kernel's IEEE
    # quotient, and the texture test compares that quotient to 0.01
    full = torch.full_like(tex, float((2 * radius + 1) ** 2))

    denom = c_m + c_p - 2.0 * cmin
    interior = (best > 0) & (best < D - 1) & (c_m < BIG) & (c_p < BIG)
    delta = torch.where(interior & (denom > 1e-9),
                        0.5 * (c_m - c_p) / torch.clamp(denom, min=1e-9),
                        torch.zeros_like(denom))
    disp = best.to(torch.float32) + torch.clamp(delta, -0.5, 0.5)

    # right-view winner: candidate for right pixel u is cost[d][u + d]
    ridx = col[None, :] + dd[:, None]  # (D, W)
    cl = torch.gather(cost, 2, ridx.clamp(max=w - 1)[:, None, :].expand(-1, h, -1))
    cl = torch.where((ridx < w)[:, None, :], cl, torch.full_like(cl, BIG))
    bestr = torch.argmin(cl, dim=0)
    bestr_c = torch.gather(cl, 0, bestr[None])[0]
    bestr = torch.where(bestr_c < BIG, bestr, torch.zeros_like(bestr))
    lr = torch.gather(bestr, 1, torch.remainder(col[None, :] - best, w))
    lr_ok = torch.abs(best - lr) <= 1

    row = torch.arange(h, device=dev)[:, None]
    in_img = (row >= radius) & (row < h - radius)
    valid = ((cmin < 1e4) & (cmin * uniqueness_ratio <= c2)
             & (tex / full > texture_threshold) & (best > 0) & in_img & lr_ok)
    return torch.where(valid, disp, torch.full_like(disp, -1.0))


def bm_plain_batched(lf: torch.Tensor, rf: torch.Tensor, num_disp: int = 64,
                     radius: int = 5, uniqueness_ratio: float = 1.10,
                     texture_threshold: float = 0.01) -> torch.Tensor:
    """Plain version of the batched kernel on prefiltered (B, H, W) images:
    :func:`bm_plain` per stream. A loop, not one (B, D, H, W) program: at
    B = 8, 512x384, D = 64 each such intermediate would be ~403 MB."""
    return torch.stack([
        bm_plain(lf[b], rf[b], num_disp, radius, uniqueness_ratio,
                 texture_threshold) for b in range(lf.shape[0])])


# -- the CUDA kernel -----------------------------------------------------------

class _Kernel:
    """The compiled shared libraries, one per disparity count, built once
    per process from the source in the checkout (keyed by the source's
    hash) into build/kernels/."""

    libs: dict = {}
    build_seconds: dict = {}
    logs: dict = {}  # num_disp -> the build's ptxas report

    @classmethod
    def load(cls, num_disp: int):
        if num_disp not in cls.libs:
            t0 = time.perf_counter()
            so = _build(_SOURCE, num_disp)
            lib = ctypes.CDLL(str(so))
            ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.stereo_bm_launch_batched.argtypes = [
                ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, f32, f32,
                ptr]
            lib.stereo_bm_launch_batched.restype = i32
            for name in ("num_disp", "radius", "tile_rows", "tile_cols",
                         "smem_bytes"):
                getattr(lib, f"stereo_bm_{name}").argtypes = []
                getattr(lib, f"stereo_bm_{name}").restype = i32
            lib.stereo_bm_error_string.argtypes = [i32]
            lib.stereo_bm_error_string.restype = ctypes.c_char_p
            built = (lib.stereo_bm_num_disp(), lib.stereo_bm_radius(),
                     (lib.stereo_bm_tile_rows(), lib.stereo_bm_tile_cols()),
                     lib.stereo_bm_smem_bytes())
            want = (num_disp, KERNEL_RADIUS, tile_shape(num_disp),
                    _smem_bytes(num_disp))
            if built != want:
                raise RuntimeError(f"{lib._name} was built for (D, radius, "
                                   f"tile, smem) {built}, expected {want}")
            cls.libs[num_disp] = lib
            cls.logs[num_disp] = so.with_suffix(".log")
            cls.build_seconds[num_disp] = time.perf_counter() - t0
        return cls.libs[num_disp]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (CUDA_HOME or /usr/local/cuda)")
    return path


def _build(source: Path, num_disp: int) -> Path:
    """nvcc -> build/kernels/libstereo_bm_d<D>_<hash>.so (skipped when
    present); the ptxas report goes beside it as .log."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libstereo_bm_d{num_disp}_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "--fmad=false", f"-DSTEREO_BM_D={num_disp}", "-Xptxas", "-v",
           "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def _check_cuda_inputs(lf, rf, ndim, num_disp, radius):
    """Raise on what the kernel does not take; returns (B, H, W)."""
    for name, x in (("left", lf), ("right", rf)):
        if not x.is_cuda or x.dtype != torch.float32 or x.dim() != ndim:
            raise ValueError(f"{name}: need a {ndim}-D float32 CUDA tensor, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if lf.shape != rf.shape or lf.device != rf.device:
        raise ValueError("left/right shape or device mismatch")
    if num_disp not in SUPPORTED_NUM_DISP:
        raise ValueError(f"num_disp {num_disp} not in {SUPPORTED_NUM_DISP}")
    if radius != KERNEL_RADIUS:
        raise ValueError(f"the CUDA kernel is built for radius "
                         f"{KERNEL_RADIUS}, got {radius}")
    smem = _smem_bytes(num_disp)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"num_disp {num_disp} needs {smem} B of shared "
                         f"memory per block (limit {_SMEM_LIMIT})")
    b, h, w = (1, *lf.shape) if ndim == 2 else lf.shape
    if h < 1 or w < 1 or h * w >= 2 ** 31:
        raise ValueError(f"image shape {(h, w)} outside 1 <= H*W < 2^31")
    if not 1 <= b <= 65535:
        raise ValueError(f"batch {b} outside the grid's 1..65535")
    return b, h, w


def _launch(lf, rf, b, h, w, num_disp, radius, uniqueness_ratio,
            texture_threshold):
    """Both kernels on prefiltered, contiguous (B, H, W) images; the
    scratch is allocated here and the keys start at ~0 (no candidate)."""
    out = torch.empty_like(lf)
    best = torch.empty(lf.shape, dtype=torch.int32, device=lf.device)
    rkey = torch.full(lf.shape, -1, dtype=torch.int64, device=lf.device)
    lib = _Kernel.load(num_disp)
    with torch.cuda.device(lf.device):
        stream = torch.cuda.current_stream(lf.device).cuda_stream
        err = lib.stereo_bm_launch_batched(
            lf.data_ptr(), rf.data_ptr(), out.data_ptr(), best.data_ptr(),
            rkey.data_ptr(), b, h, w, num_disp, radius,
            float(uniqueness_ratio), float(texture_threshold), stream)
    if err != 0:
        raise RuntimeError("stereo_bm kernel launch failed: "
                           + lib.stereo_bm_error_string(err).decode())
    return out


def bm_cuda(lf: torch.Tensor, rf: torch.Tensor, num_disp: int = 64,
            radius: int = 5, uniqueness_ratio: float = 1.10,
            texture_threshold: float = 0.01) -> torch.Tensor:
    """Run the CUDA kernels on prefiltered (H, W) images: B = 1 of the
    batched grid (no counting: the dispatcher counts)."""
    _, h, w = _check_cuda_inputs(lf, rf, 2, num_disp, radius)
    return _launch(lf.contiguous()[None], rf.contiguous()[None], 1, h, w,
                   num_disp, radius, uniqueness_ratio, texture_threshold)[0]


def bm_cuda_batched(lf: torch.Tensor, rf: torch.Tensor, num_disp: int = 64,
                    radius: int = 5, uniqueness_ratio: float = 1.10,
                    texture_threshold: float = 0.01) -> torch.Tensor:
    """Run the CUDA kernels once on prefiltered (B, H, W) images, all B
    streams in one grid (no counting: the dispatcher counts)."""
    b, h, w = _check_cuda_inputs(lf, rf, 3, num_disp, radius)
    return _launch(lf.contiguous(), rf.contiguous(), b, h, w, num_disp,
                   radius, uniqueness_ratio, texture_threshold)


class _CaptureLog(threading.local):
    """The counted wrappers called on this thread while it captures a CUDA
    graph (``calls`` is a list then, None otherwise)."""

    calls = None


CAPTURED = _CaptureLog()


def _count(wrapper):
    """One launch of `wrapper`'s kernels, or one recorded into the graph
    this thread is capturing."""
    if CAPTURED.calls is not None:
        CAPTURED.calls.append(wrapper)
    else:
        wrapper.launches += 1


def block_matching_disparity_bm(
    left: torch.Tensor,
    right: torch.Tensor,
    num_disp: int = 64,
    radius: int = 5,
    uniqueness_ratio: float = 1.10,
    texture_threshold: float = 0.01,
) -> torch.Tensor:
    """Dense disparity with the block-matching kernel's semantics (stereo
    method 2). Prefilters, then runs the CUDA kernel for a CUDA tensor or
    the plain version for a CPU tensor. Returns f32 (H, W), -1 invalid."""
    lf = _sobel_x_prefilter(left)
    rf = _sobel_x_prefilter(right)
    if lf.is_cuda:
        out = bm_cuda(lf, rf, num_disp, radius, uniqueness_ratio,
                      texture_threshold)
        _count(block_matching_disparity_bm)
        return out
    if lf.device.type != "cpu":
        raise ValueError(f"no block-matching kernel for device {lf.device}")
    return bm_plain(lf, rf, num_disp, radius, uniqueness_ratio,
                    texture_threshold)


block_matching_disparity_bm.launches = 0


def block_matching_disparity_bm_batched(
    left: torch.Tensor,
    right: torch.Tensor,
    num_disp: int = 64,
    radius: int = 5,
    uniqueness_ratio: float = 1.10,
    texture_threshold: float = 0.01,
) -> torch.Tensor:
    """:func:`block_matching_disparity_bm` for B streams at once: (B, H, W)
    in, f32 (B, H, W) out. Prefilters each stream, then makes ONE kernel
    launch for a CUDA tensor or runs the plain version for a CPU tensor."""
    if left.dim() != 3 or left.shape != right.shape:
        raise ValueError(f"need two (B, H, W) tensors of one shape, got "
                         f"{tuple(left.shape)} and {tuple(right.shape)}")
    prefilter = torch.func.vmap(_sobel_x_prefilter)
    lf, rf = prefilter(left), prefilter(right)
    if lf.is_cuda:
        out = bm_cuda_batched(lf, rf, num_disp, radius, uniqueness_ratio,
                              texture_threshold)
        _count(block_matching_disparity_bm_batched)
        return out
    if lf.device.type != "cpu":
        raise ValueError(f"no block-matching kernel for device {lf.device}")
    return bm_plain_batched(lf, rf, num_disp, radius, uniqueness_ratio,
                            texture_threshold)


block_matching_disparity_bm_batched.launches = 0

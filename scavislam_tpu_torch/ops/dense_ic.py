"""One inverse-compositional evaluation of the dense tracker: the
hand-written Hopper kernel and its plain twin.

``ic_pass(img, R, t, xyz_ref, i_ref, J_ref, valid, focal, pp)`` is (H, b,
chi2) = (J^T J, J^T r, r^T r) at the candidate pose (R, t) over a
reference cloud: each point transformed and projected, the clamped
photometric residual of the exact bilinear sample where the point lies in
the frame (2-px border, z > 1e-6, valid), the fixed template Jacobian row
there, and nothing elsewhere. ``models.dense_tracker._lm_level_ic`` calls
it once before its trips and once in each: 93 times a frame step.

Dispatch, from the input alone: a CPU tensor runs the plain PyTorch
version (``ic_pass_plain``), which is the port's ``_ic_pass`` as it was
and the CPU's path bit for bit, under ``torch.func.vmap`` too (a vmapped
CPU program keeps batching its operations); a CUDA tensor runs the CUDA
kernels (``csrc/dense_ic.cu``: one partial-sum pass over the cloud and one
fixed-order final sum, no atomics), or raises. There is no fallback
between them.

The kernels are reached through the operator ``dense_ic``
(``torch.ops.scavislam_tpu_torch.dense_ic``) over L lanes, (L, ...)
inputs to (L, 6, 6), (L, 6), (L,) outputs. Its vmap rule folds the mapped
dimension into the lanes (an unmapped argument is shared by every lane at
stride 0), so the multistream step's vmapped LM makes one launch a call
for all its streams. Lanes need contiguous inner blocks at any lane
stride. The program calls the operator on a card only; its CPU
implementation (the plain version lane by lane) is there so that the
tests hold the vmap rule and the input checks without a card.

The library is compiled for ``sm_90a`` with nvcc at first use into
``build/kernels/`` and bound with ctypes (as ``ops/stereo_bm.py``); it
launches on PyTorch's current stream. ``ic_pass.launches`` counts calls
that launch the kernels, one per call whatever the lanes; a call recorded
into a CUDA graph is noted in ``stereo_bm.CAPTURED`` and counted at each
replay (``models/step_graph.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

from scavislam_tpu_torch.ops.image import float_to_index
from scavislam_tpu_torch.ops.stereo_bm import _count, _nvcc

RES_CLAMP = 0.1
BORDER = 2
ACCUMULATORS = 28  # 21 of J^T J, 6 of J^T r, r^T r
THREADS = 256  # threads of a partial-sum block
# partial-sum blocks per lane: one point a thread up to 256 blocks (65,536
# points); the same whatever the lanes, so a lane's sums run in one order
# alone or batched
MAX_BLOCKS = 256

_REPO = Path(__file__).resolve().parents[2]
_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "dense_ic.cu"
BUILD_DIR = _REPO / "build" / "kernels"


# -- plain PyTorch version ---------------------------------------------------

def project(focal, pp, xyz_cur):
    """(z, uv) of camera-frame points (..., 3) through a pinhole with
    host-float intrinsics."""
    z = xyz_cur[..., 2]
    return z, torch.stack([xyz_cur[..., 0] / z * focal + pp[0],
                           xyz_cur[..., 1] / z * focal + pp[1]], dim=-1)


def in_frame(uv, z, w, h, valid):
    return ((uv[..., 0] >= BORDER) & (uv[..., 0] < w - BORDER)
            & (uv[..., 1] >= BORDER) & (uv[..., 1] < h - BORDER)
            & (z > 1e-6) & valid)


def sample_exact(img, h, w, uv):
    """Bilinear sample with the twin's _sample_qpack semantics (clamped
    base, fractions from the clamped base). Returns (values, in_bounds)."""
    u = uv[..., 0]
    v = uv[..., 1]
    valid = (u >= 0.0) & (v >= 0.0) & (u <= w - 1.0) & (v <= h - 1.0)
    u0c = float_to_index(torch.floor(u)).clamp(0, w - 2)
    v0c = float_to_index(torch.floor(v)).clamp(0, h - 2)
    fu = u - u0c.to(u.dtype)
    fv = v - v0c.to(v.dtype)
    flat = img.reshape(-1)
    base = (v0c * w + u0c).long()
    top = flat[base] * (1.0 - fu) + flat[base + 1] * fu
    bot = flat[base + w] * (1.0 - fu) + flat[base + w + 1] * fu
    return top * (1.0 - fv) + bot * fv, valid


def ic_pass_plain(img, R, t, xyz_ref, i_ref, J_ref, valid, focal, pp):
    """The evaluation in plain PyTorch on one (h, w) image and (N, ...)
    cloud: masked (H, b, chi2) with the fixed template Jacobian."""
    h, w = img.shape
    z, uv = project(focal, pp, xyz_ref @ R.T + t)
    i_cur, _ = sample_exact(img, h, w, uv)
    inside = in_frame(uv, z, w, h, valid)
    res = torch.clamp(i_ref - i_cur, -RES_CLAMP, RES_CLAMP)
    res = torch.where(inside, res, torch.zeros_like(res))
    Jm = torch.where(inside[..., None], J_ref, torch.zeros_like(J_ref))
    H = Jm.T @ Jm
    b = Jm.T @ res
    chi2 = torch.sum(res * res)
    return H, b, chi2


# -- the CUDA kernels ----------------------------------------------------------

class _Kernel:
    """The compiled shared library, built once per process from the
    source in the checkout (keyed by the source's hash) into
    build/kernels/."""

    lib = None
    build_seconds = None
    log = None  # the build's ptxas report

    @classmethod
    def load(cls):
        if cls.lib is None:
            t0 = time.perf_counter()
            so = _build(_SOURCE)
            lib = ctypes.CDLL(str(so))
            ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_longlong, ctypes.c_float)
            lib.dense_ic_launch.argtypes = (
                [ptr, i64] * 7 + [i32] * 4 + [f32] * 3 + [i32]
                + [ptr] * 5)
            lib.dense_ic_launch.restype = i32
            for name in ("accumulators", "threads"):
                getattr(lib, f"dense_ic_{name}").argtypes = []
                getattr(lib, f"dense_ic_{name}").restype = i32
            lib.dense_ic_error_string.argtypes = [i32]
            lib.dense_ic_error_string.restype = ctypes.c_char_p
            built = (lib.dense_ic_accumulators(), lib.dense_ic_threads())
            if built != (ACCUMULATORS, THREADS):
                raise RuntimeError(f"{lib._name} was built for (sums, "
                                   f"threads) {built}, expected "
                                   f"{(ACCUMULATORS, THREADS)}")
            cls.log = so.with_suffix(".log")
            cls.build_seconds = time.perf_counter() - t0
            cls.lib = lib
        return cls.lib


def _build(source: Path) -> Path:
    """nvcc -> build/kernels/libdense_ic_<hash>.so (skipped when present);
    the ptxas report goes beside it as .log."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libdense_ic_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
           "-fPIC", "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def blocks_per_lane(n: int) -> int:
    """Partial-sum blocks of one lane over `n` points."""
    return max(1, min(-(-n // THREADS), MAX_BLOCKS))


_SHAPES = (("img", None, torch.float32), ("R", (3, 3), torch.float32),
           ("t", (3,), torch.float32), ("xyz_ref", ("n", 3), torch.float32),
           ("i_ref", ("n",), torch.float32),
           ("J_ref", ("n", 6), torch.float32), ("valid", ("n",), torch.bool))


def check_lanes(img, R, t, xyz_ref, i_ref, J_ref, valid):
    """Raise on what the operator does not take; returns (L, n, h, w).
    Each argument has a leading lane axis of one length L, any stride
    along it, and a contiguous block per lane."""
    args = (img, R, t, xyz_ref, i_ref, J_ref, valid)
    if img.dim() != 3:
        raise ValueError(f"img: need (L, h, w), got {tuple(img.shape)}")
    lanes, h, w = img.shape
    n = xyz_ref.shape[1] if xyz_ref.dim() == 3 else -1
    for (name, inner, dtype), x in zip(_SHAPES, args):
        want = (h, w) if inner is None else tuple(n if d == "n" else d
                                                  for d in inner)
        if tuple(x.shape) != (lanes, *want) or x.dtype != dtype:
            raise ValueError(f"{name}: need {dtype} of shape "
                             f"{(lanes, *want)}, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.device != img.device:
            raise ValueError(f"{name} on {x.device}, img on {img.device}")
        if not x[0].is_contiguous():
            raise ValueError(f"{name}: each lane's block must be contiguous")
    if not 1 <= lanes <= 65535:
        raise ValueError(f"{lanes} lanes outside the grid's 1..65535")
    if h < 2 or w < 2 or h * w >= 2 ** 31 or 6 * n >= 2 ** 31:
        raise ValueError(f"image {(h, w)} or cloud of {n} points too large "
                         "or too small")
    return lanes, n, h, w


def _launch(img, R, t, xyz_ref, i_ref, J_ref, valid, focal, px, py):
    lanes, n, h, w = check_lanes(img, R, t, xyz_ref, i_ref, J_ref, valid)
    dev = img.device
    nblk = blocks_per_lane(n)
    H = torch.empty((lanes, 6, 6), dtype=torch.float32, device=dev)
    b = torch.empty((lanes, 6), dtype=torch.float32, device=dev)
    chi2 = torch.empty((lanes,), dtype=torch.float32, device=dev)
    partial = torch.empty((lanes, nblk, ACCUMULATORS), dtype=torch.float64,
                          device=dev)
    lib = _Kernel.load()
    lane_args = []
    for x in (img, R, t, xyz_ref, i_ref, J_ref, valid):
        lane_args += [x.data_ptr(), x.stride(0) if lanes > 1 else 0]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dense_ic_launch(
            *lane_args, lanes, n, h, w, focal, px, py, nblk,
            partial.data_ptr(), H.data_ptr(), b.data_ptr(), chi2.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError("dense_ic kernel launch failed: "
                           + lib.dense_ic_error_string(err).decode())
    _count(ic_pass)
    return H, b, chi2


# -- the operator ----------------------------------------------------------------
# defined with torch.library.Library, not the custom_op decorator: a
# custom_op's kernels run under torch._disable_dynamo, whose first call
# imports torch._dynamo, sympy and DTensor's operator tables (2 s on a CPU,
# ~10 s of a benchmark run's set-up on the card's host)

_LIB = torch.library.Library("scavislam_tpu_torch", "DEF")
_LIB.define("dense_ic(Tensor img, Tensor R, Tensor t, Tensor xyz_ref, "
            "Tensor i_ref, Tensor J_ref, Tensor valid, float focal, "
            "float px, float py) -> (Tensor, Tensor, Tensor)")
dense_ic = torch.ops.scavislam_tpu_torch.dense_ic
"""The evaluation over L lanes: (L, h, w), (L, 3, 3), (L, 3), (L, N, 3),
(L, N), (L, N, 6), (L, N) -> H (L, 6, 6), b (L, 6), chi2 (L,)."""


def _plain_lanes(img, R, t, xyz_ref, i_ref, J_ref, valid, focal, px, py):
    check_lanes(img, R, t, xyz_ref, i_ref, J_ref, valid)
    outs = [ic_pass_plain(*lane, focal, (px, py))
            for lane in zip(img, R, t, xyz_ref, i_ref, J_ref, valid)]
    return tuple(torch.stack(x) for x in zip(*outs))


_LIB.impl("dense_ic", _plain_lanes, "CPU")
_LIB.impl("dense_ic", _launch, "CUDA")


def _lanes_of(x, dim, size):
    """`x` with the mapped dimension `dim` (None: unmapped) folded into its
    leading lane axis: (size * L, ...)."""
    if dim is None:
        x = x.expand(size, *x.shape)
    else:
        x = x.movedim(dim, 0)
    x = x.flatten(0, 1)
    return x if x[0].is_contiguous() else x.contiguous()


def _dense_ic_vmap(info, in_dims, img, R, t, xyz_ref, i_ref, J_ref, valid,
                   focal, px, py):
    size = info.batch_size
    tensors = [_lanes_of(x, d, size) for x, d in
               zip((img, R, t, xyz_ref, i_ref, J_ref, valid), in_dims)]
    outs = dense_ic(*tensors, focal, px, py)
    return tuple(x.unflatten(0, (size, -1)) for x in outs), (0, 0, 0)


torch.library.register_vmap("scavislam_tpu_torch::dense_ic", _dense_ic_vmap,
                            lib=_LIB)


def ic_pass(img, R, t, xyz_ref, i_ref, J_ref, valid, focal, pp):
    """(H, b, chi2) at pose (R, t) on one (h, w) image and (N, ...)
    cloud: the plain version for a CPU tensor, the CUDA kernels (one call
    of the operator, as lane 0 of 1) for a CUDA tensor."""
    if img.is_cuda:
        H, b, chi2 = dense_ic(
            *(x.contiguous()[None]
              for x in (img, R, t, xyz_ref, i_ref, J_ref, valid)),
            float(focal), float(pp[0]), float(pp[1]))
        return H[0], b[0], chi2[0]
    if img.device.type != "cpu":
        raise ValueError(f"no dense_ic kernel for device {img.device}")
    return ic_pass_plain(img, R, t, xyz_ref, i_ref, J_ref, valid, focal, pp)


ic_pass.launches = 0

"""Multi-stream batched steps (port of scavislam_tpu.parallel.multistream,
one-device case).

The twin runs N independent camera streams as one vmapped program,
optionally shard_mapped over a ("dp", "sp") device mesh. The port runs on one
H100: the stream axis is a leading batch dimension, and a mesh is refused
(NotImplementedError) until the multi-card slice (ROADMAP queue 1).

- :func:`tracking_core`: motion-only GN tracking of B streams at once (the
  twin's ``_tracking_core`` with ``sp_axis=None`` under vmap), a fixed trip
  count with no host sync;
- :func:`build_multistream_step`: that core behind the twin's builder;
- :func:`build_multistream_frontend`: the full per-frame frontend step over
  B streams. On a CUDA device the disparity of all B streams comes from ONE
  call of the batched block-matching kernels; each stream's step then runs
  on that external disparity. The per-stream stages run as a loop over the
  streams: vmap's semantics are independent streams, and a loop keeps them
  exactly.

- :func:`build_multistream_mono`: the per-frame MONOCULAR step
  (``models.mono_step``) over B streams, each with its own pose / point /
  Lambda tables; no stereo stage. The per-stream steps run as a loop.

Not ported yet: ``make_mesh``, ``shard_stream_batch`` and
``build_sharded_ba`` (the multi-card slice).
"""

from __future__ import annotations

import torch

from scavislam_tpu_torch.core.lie import SE3, hat
from scavislam_tpu_torch.models.frontend_step import (
    DENSE_SUBS,
    FrontendStepOut,
    frontend_step,
    normalize_frames,
)
from scavislam_tpu_torch.ops.image import binomial3
from scavislam_tpu_torch.ops.stereo_bm import (
    block_matching_disparity_bm_batched,
)

STEREO_ROUTES = ("kernel", "twin")


def _refuse_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh (multi-card streams, sharded BA) is not ported "
            "yet: ROADMAP queue 1, multistream; pass mesh=None for one card")


def stack_streams(items):
    """Stack per-stream values (tensors, or tuples / NamedTuples of them,
    nested) along a new leading stream axis, keeping the structure."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if isinstance(first, tuple):
        fields = [stack_streams(list(xs)) for xs in zip(*items)]
        return type(first)(*fields) if hasattr(first, "_fields") else tuple(fields)
    raise TypeError(f"cannot stack {type(first).__name__}")


def stream_slice(batched, s: int):
    """Stream `s` of a value built by :func:`stack_streams` (views)."""
    if isinstance(batched, torch.Tensor):
        return batched[s]
    fields = [stream_slice(x, s) for x in batched]
    return type(batched)(*fields) if hasattr(batched, "_fields") else tuple(fields)


def _normal_eq(cam_params, R, t, xyz_w, obs_uvu, weights, valid):
    """Per-stream 6x6 normal equations of the robust stereo reprojection
    error: (B, 6, 6) H, (B, 6) b, (B,) chi2."""
    focal, ppx, ppy, baseline = cam_params
    y = torch.einsum("bij,bnj->bni", R, xyz_w) + t[:, None, :]
    y0, y1, y2 = y[..., 0], y[..., 1], y[..., 2]
    z = torch.where(torch.abs(y2) < 1e-6, torch.full_like(y2, 1e-6), y2)
    u = y0 / z * focal + ppx
    v = y1 / z * focal + ppy
    ur = (y0 - baseline) / z * focal + ppx
    r = obs_uvu - torch.stack([u, v, ur], dim=-1)
    mask = valid & (y2 > 0.1) & torch.all(torch.isfinite(r), dim=-1)
    r = torch.where(mask[..., None], r, torch.zeros_like(r))
    s = torch.sum(r * r, dim=-1)
    w = weights * mask / torch.sqrt(1.0 + s)
    z2 = z * z
    zero = torch.zeros_like(z)
    j0 = torch.stack([focal / z, zero, -focal * y0 / z2], -1)
    j1 = torch.stack([zero, focal / z, -focal * y1 / z2], -1)
    j2 = torch.stack([focal / z, zero, -focal * (y0 - baseline) / z2], -1)
    Jp = torch.stack([j0, j1, j2], dim=-2)  # (B, N, 3, 3)
    eye = torch.eye(3, dtype=y.dtype, device=y.device).expand(*z.shape, 3, 3)
    J = Jp @ torch.cat([eye, -hat(y)], dim=-1)  # (B, N, 3, 6)
    Jw = J * w[..., None, None]
    H = torch.einsum("bnij,bnik->bjk", Jw, J)
    b = torch.einsum("bnij,bni->bj", Jw, r)
    return H, b, torch.sum(w * s, dim=-1)


def tracking_core(cam_params, R, t, xyz_w, obs_uvu, weights, valid,
                  iters: int = 5):
    """Motion-only GN tracking of B streams, `iters` fixed iterations.

    R (B, 3, 3), t (B, 3), xyz_w / obs_uvu (B, N, 3), weights / valid
    (B, N). Each iteration solves the damped (B, 6, 6) systems by Cholesky
    on the device (a failed factorization or a non-finite step gives a zero
    step, the twin's guard) and left-multiplies exp(x). Returns (R, t,
    chi2 of the last iteration's linearization point)."""
    chi = None
    eye6 = torch.eye(6, dtype=R.dtype, device=R.device)
    for _ in range(iters):
        H, b, chi = _normal_eq(cam_params, R, t, xyz_w, obs_uvu, weights,
                               valid)
        Hd = H + 1e-2 * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1)) \
            + 1e-9 * eye6
        L, info = torch.linalg.cholesky_ex(Hd)
        x = torch.cholesky_solve(b[..., None], L)[..., 0]
        ok = (info == 0)[:, None] & torch.isfinite(x)
        x = torch.where(ok, x, torch.zeros_like(x))
        T = SE3.exp(x) @ SE3(R, t)
        R, t = T.R, T.t
    return R, t, chi


def build_multistream_step(mesh, cam_params, iters: int = 5):
    """The batched tracking core as a step over stream batches:
    step(R (B,3,3), t (B,3), xyz_w (B,N,3), obs_uvu (B,N,3), weights (B,N),
    valid (B,N)) -> (R, t, chi2 (B,)). `mesh` must be None (one card)."""
    _refuse_mesh(mesh)

    def step(R, t, xyz_w, obs_uvu, weights, valid):
        return tracking_core(cam_params, R, t, xyz_w, obs_uvu, weights,
                             valid, iters)

    return step


def build_multistream_frontend(mesh, cam_params, cam_statics, levels=3,
                               num_disp=64, max_reproj=2.0, dense_subs=None,
                               dense_sample="matmul", stereo=None):
    """The full per-frame frontend step over a batch of B streams.

    Returns step(frames (B, 2, H, W), clouds, intens, valids, Js (per-level
    tuples of (B, ...) tensors), R (B, 3, 3), t (B, 3), actkey (B host
    ints), poses, points (tables with a leading B axis), cand (B, C)) ->
    FrontendStepOut with a leading stream axis on every leaf.

    Stereo routes (`stereo`; None picks by the frames' device):
    - "kernel" (default on a CUDA device): uint8 -> f32, the 3x3 binomial
      sensor-noise prefilter per stream, then ONE batched block-matching
      call for all B streams; each stream's step runs on that external
      disparity, so it computes what a single-stream step computes at
      stereo method 2. (The twin hands the RAW frames to its batched TPU
      kernel, skipping the prefilter its single-stream step applies; the
      port does not copy that.) On a CPU tensor the batched kernel's plain
      version runs instead.
    - "twin" (default on the CPU): each stream's step at stereo method 1,
      the cost-volume twin — what the JAX package runs on the CPU.

    `mesh` must be None (one card)."""
    _refuse_mesh(mesh)
    if stereo is not None and stereo not in STEREO_ROUTES:
        raise ValueError(f"stereo {stereo!r} not in {STEREO_ROUTES}")
    subs = tuple(dense_subs) if dense_subs is not None else DENSE_SUBS

    def step(frames, clouds, intens, valids, Js, R, t, actkey, poses,
             points, cand) -> FrontendStepOut:
        route = stereo or ("kernel" if frames.is_cuda else "twin")
        n = frames.shape[0]
        actkey = [int(a) for a in actkey]
        if route == "kernel":
            frames_f = normalize_frames(frames)
            left_s = torch.stack([binomial3(x) for x in frames_f[:, 0]])
            right_s = torch.stack([binomial3(x) for x in frames_f[:, 1]])
            disp = block_matching_disparity_bm_batched(
                left_s, right_s, num_disp=num_disp, radius=5)
            frames = torch.cat([frames_f, disp[:, None]], dim=1)
        use_ext, method = (True, 2) if route == "kernel" else (False, 1)
        outs = [
            frontend_step(
                frames[s], stream_slice(clouds, s), stream_slice(intens, s),
                stream_slice(valids, s), stream_slice(Js, s), R[s], t[s],
                actkey[s], stream_slice(poses, s), stream_slice(points, s),
                cand[s], cam_params, cam_statics, levels, num_disp, use_ext,
                max_reproj, method, dense_subs=subs,
                dense_sample=dense_sample)
            for s in range(n)
        ]
        return stack_streams(outs)

    return step


def build_multistream_mono(mesh, cam_params, cam_statics, levels=3,
                           zmssd_thr=0.18):
    """The per-frame monocular step over a batch of B streams.

    Returns step(imgs (B, H, W), R (B, 3, 3), t (B, 3), ak (B,), poses,
    points (tables with a leading B axis), Lam (B, P, 3, 3), cand (B, C),
    conv_thr (B,), prior_w (B,)) -> MonoStepOut with a leading stream axis
    on every leaf. `mesh` must be None (one card)."""
    from scavislam_tpu_torch.models.mono_step import mono_step

    _refuse_mesh(mesh)

    def step(imgs, R, t, ak, poses, points, Lam, cand, conv, pw):
        outs = [
            mono_step(imgs[s], R[s], t[s], ak[s], stream_slice(poses, s),
                      stream_slice(points, s), Lam[s], cand[s], conv[s],
                      pw[s], cam_params, cam_statics, levels, 2.0, zmssd_thr)
            for s in range(imgs.shape[0])
        ]
        return stack_streams(outs)

    return step

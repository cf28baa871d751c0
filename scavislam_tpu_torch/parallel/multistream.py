"""Multi-stream batched steps over a device mesh (port of
scavislam_tpu.parallel.multistream).

The twin runs N independent camera streams as one vmapped program,
shard_mapped over a ("dp", "sp") device mesh. The port does the same with
``torch.func.vmap`` over the stream axis, and runs a mesh in one process
with explicit devices (parallel/mesh.py): each build function splits its
global inputs by the twin's partition specs, moves each shard to its
device, launches every shard's work before any reduction, sums partials
in fixed shard order on shard 0's device, and gathers global outputs to
the mesh's first device. ``mesh=None`` runs everything on the inputs' device.

- :func:`tracking_core`: motion-only GN tracking of B streams at once (the
  twin's ``_tracking_core``), a fixed trip count with no host sync; with
  the observation axis sharded over "sp", each iteration sums the shards'
  partial 6x6 normal equations (the twin's psum);
- :func:`build_multistream_step`: that core behind the twin's build function,
  streams over "dp", observations over "sp";
- :func:`build_sharded_ba`: the DWO bundle-adjustment solve with its
  observation axis sharded over a mesh axis (models.ba_solver's
  ``sp_axis``);
- :func:`build_multistream_frontend`: the full per-frame frontend step over
  B streams as ONE program, the twin's ``vstep``: on a CUDA device one
  call of the batched block-matching kernels for the streams of a shard,
  then ``vmap`` of one stream's ``frontend_step`` over the stream axis;
- :func:`build_multistream_mono`: ``vmap`` of the per-frame monocular step
  (``models.mono_step``) over B streams, each with its own pose / point /
  Lambda tables; no stereo stage;
- :func:`make_mesh` and :func:`shard_stream_batch`.

Both step builders return an :class:`OverDp`: the eager program for CPU
tensors, and one ``models.step_graph.GraphedFn`` per "dp" shard, which on
a card replays the whole program as one CUDA graph (captured at the first
call), as the twin's ``jax.jit`` runs it. The program runs one stream's
step in ``dense_tracker.lanes``: its fixed-trip LMs run every trip, as
they do on a card, and solve their damped systems with a capturable
batched solve (``dense_tracker.cho_solve``). A lane rounds differently
from the same stream's single-stream step (batched matrix products sum in
another order); tests/test_torch_multistream_vmap.py holds the lanes to
it.
"""

from __future__ import annotations

import torch

from scavislam_tpu_torch.core.lie import SE3, hat
from scavislam_tpu_torch.models.dense_tracker import lanes
from scavislam_tpu_torch.models.frontend_step import (
    DENSE_SUBS,
    FrontendStepOut,
    frontend_step,
    normalize_frames,
)
from scavislam_tpu_torch.models.mono_step import mono_step
from scavislam_tpu_torch.models.step_graph import GraphedFn
from scavislam_tpu_torch.ops.image import binomial3
from scavislam_tpu_torch.ops.stereo_bm import (
    block_matching_disparity_bm_batched,
)
from scavislam_tpu_torch.parallel.mesh import (
    gather,
    make_mesh,  # noqa: F401 (the twin defines make_mesh in this module)
    split,
    to_device,
)

STEREO_ROUTES = ("kernel", "twin")


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


def _gn_update(R, t, H, b):
    """One damped GN step from summed normal equations: Cholesky on the
    device (a failed factorization or a non-finite step gives a zero step,
    the twin's guard), then left-multiply exp(x)."""
    eye6 = torch.eye(6, dtype=R.dtype, device=R.device)
    Hd = H + 1e-2 * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1)) \
        + 1e-9 * eye6
    L, info = torch.linalg.cholesky_ex(Hd)
    x = torch.cholesky_solve(b[..., None], L)[..., 0]
    ok = (info == 0)[:, None] & torch.isfinite(x)
    x = torch.where(ok, x, torch.zeros_like(x))
    T = SE3.exp(x) @ SE3(R, t)
    return T.R, T.t


def _sharded_tracking(cam_params, rows, iters, psum):
    """GN tracking over a grid of shards: rows[i][j] = (R, t, xyz_w,
    obs_uvu, weights, valid) of stream group i and observation slice j,
    each on its device. Every iteration builds all shards' partial normal
    equations, then sums each row over its slices (`psum(parts, i)`, one
    sum per slice) and updates every slice's copy of the pose. Returns
    [(R, t, chi2)] per row, from slice 0."""
    state = [[sh[:2] for sh in row] for row in rows]
    chi = [None] * len(rows)
    for _ in range(iters):
        parts = [[_normal_eq(cam_params, *state[i][j], *sh[2:])
                  for j, sh in enumerate(row)] for i, row in enumerate(rows)]
        for i in range(len(rows)):
            sums = psum(parts[i], i)
            chi[i] = sums[0][2]
            state[i] = [_gn_update(*state[i][j], H, b)
                        for j, (H, b, _) in enumerate(sums)]
    return [(*state[i][0], chi[i]) for i in range(len(rows))]


def tracking_core(cam_params, R, t, xyz_w, obs_uvu, weights, valid,
                  iters: int = 5):
    """Motion-only GN tracking of B streams, `iters` fixed iterations.

    R (B, 3, 3), t (B, 3), xyz_w / obs_uvu (B, N, 3), weights / valid
    (B, N). Each iteration solves the damped (B, 6, 6) systems by Cholesky
    on the device and left-multiplies exp(x). Returns (R, t, chi2 of the
    last iteration's linearization point)."""
    (out,) = _sharded_tracking(
        cam_params, [[(R, t, xyz_w, obs_uvu, weights, valid)]], iters,
        lambda parts, _i: parts)
    return out


def build_multistream_step(mesh, cam_params, iters: int = 5):
    """The batched tracking core as a step over stream batches:
    step(R (B,3,3), t (B,3), xyz_w (B,N,3), obs_uvu (B,N,3), weights (B,N),
    valid (B,N)) -> (R, t, chi2 (B,)), global shapes in and out.

    With a mesh the twin's specs hold: R and t split over "dp", the
    observation arrays over ("dp", "sp"); each "dp" row sums its "sp"
    slices' normal equations every iteration. Outputs on the mesh's first
    device."""
    if mesh is None:
        def step(R, t, xyz_w, obs_uvu, weights, valid):
            return tracking_core(cam_params, R, t, xyz_w, obs_uvu, weights,
                                 valid, iters)
        return step

    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    grid = mesh.devices

    def step(R, t, xyz_w, obs_uvu, weights, valid):
        poses = split((R, t), dp, lambda i: grid[i, 0])
        obs = split((xyz_w, obs_uvu, weights, valid), dp,
                    lambda i: grid[i, 0])
        rows = []
        for i in range(dp):
            slices = split(obs[i], sp, lambda j, i=i: grid[i, j], dim=1)
            rows.append([(*to_device(poses[i], grid[i, j]), *slices[j])
                         for j in range(sp)])
        sp_axis = mesh.axis("sp")
        out = _sharded_tracking(
            cam_params, rows, iters,
            lambda parts, i: sp_axis.psum(parts, list(grid[i, :])))
        return gather(out, mesh.first)

    return step


def shard_stream_batch(mesh, arrays_specs):
    """The twin places each array by a PartitionSpec before a step. The
    port's build functions take global arrays and place the shards
    themselves, so this checks that every dimension named in a spec (a
    tuple of "dp" / "sp" / None per dimension) divides over its axis, and
    returns the arrays on the mesh's first device."""
    out = []
    for arr, spec in arrays_specs:
        arr = torch.as_tensor(arr)
        for dim, ax in enumerate(spec):
            if ax is not None and arr.shape[dim] % mesh.shape[ax]:
                raise ValueError(f"dim {dim} of size {arr.shape[dim]} does "
                                 f"not split over {ax}={mesh.shape[ax]}")
        out.append(arr.to(mesh.first))
    return out


def build_sharded_ba(mesh, cam_params, iters: int = 2, huber: float = 3.0,
                     axis: str = "sp"):
    """The DWO bundle-adjustment solve with the OBSERVATION axis sharded
    over the mesh's `axis`: each shard builds the normal equations of its
    observation slice (edges on shard 0 only), the shards' partials are
    summed on shard 0's device, and the LM runs on the summed system
    there. Pose / point / edge tables are replicated. Returns step(prob)
    -> (R, t, psi, chi2_final) on the mesh's first device."""
    from scavislam_tpu_torch.models.ba_solver import solve_ba

    group = mesh.axis(axis)

    def step(prob):
        R, t, psi, stats = solve_ba(cam_params, prob, iters=iters,
                                    huber=huber, sp_axis=group)
        return R, t, psi, stats.chi2_final

    return step


class OverDp:
    """A program over a stream batch: run as it is on CPU tensors, and on
    CUDA tensors as CUDA graph replays (``graphs``: one ``GraphedFn`` per
    "dp" shard, one graph per static key, captured at the first call on
    the caller's thread; no eager run after it). With a mesh the batch is
    split into B / dp streams per "dp" shard (every argument's leading
    axis; host lists are sliced), each shard's program runs on its device,
    and the outputs are gathered to the mesh's first device. Argument
    `actkey_arg` (the active keyframes: host ints or a tensor) becomes a
    (B,) int32 tensor on the frames' device, since a graph keys on the
    values of non-tensor arguments."""

    def __init__(self, mesh, program, actkey_arg):
        self.mesh = mesh
        self.program = program
        self.actkey_arg = actkey_arg
        n = 1 if mesh is None else mesh.shape["dp"]
        self.graphs = [GraphedFn(program) for _ in range(n)]

    def _run(self, i, args):
        return (self.graphs[i] if args[0].is_cuda else self.program)(*args)

    def __call__(self, *args):
        args = list(args)
        k = self.actkey_arg
        args[k] = torch.as_tensor(args[k], dtype=torch.int32,
                                  device=args[0].device)
        if self.mesh is None:
            return self._run(0, args)
        dp = len(self.graphs)
        devs = self.mesh.axis("dp").devices
        parts = [split(a, dp, devs.__getitem__) for a in args]
        return gather([self._run(i, [p[i] for p in parts])
                       for i in range(dp)], self.mesh.first)


def build_multistream_frontend(mesh, cam_params, cam_statics, levels=3,
                               num_disp=64, max_reproj=2.0, dense_subs=None,
                               stereo=None):
    """The full per-frame frontend step over a batch of B streams: the
    twin's ``vstep``, one program over the stream axis.

    Returns step(frames (B, 2, H, W), clouds, intens, valids, Js (per-level
    tuples of (B, ...) tensors), R (B, 3, 3), t (B, 3), actkey ((B,) int
    tensor or host ints), poses, points (tables with a leading B axis),
    cand (B, C)) -> FrontendStepOut with a leading stream axis on every
    leaf, as an :class:`OverDp`.

    The program: the stereo route's disparity for all B streams, then
    ``torch.func.vmap`` of one stream's ``frontend_step`` over the stream
    axis. Stereo routes (`stereo`; None picks by the frames' device):
    - "kernel" (default on a CUDA device): uint8 -> f32, the 3x3 binomial
      sensor-noise prefilter over the (B, H, W) stacks, then ONE batched
      block-matching call; each stream's step runs on that external
      disparity, so it computes what a single-stream step computes at
      stereo method 2. (The twin hands the RAW frames to its batched TPU
      kernel, skipping the prefilter its single-stream step applies; the
      port does not copy that.) On a CPU tensor the batched kernel's plain
      version runs instead.
    - "twin" (default on the CPU): each stream's step at stereo method 1,
      the cost-volume twin — what the JAX package runs on the CPU.

    On a card the whole program (prefilter, batched kernel, vmapped step)
    is one CUDA graph replay per call. With a mesh, every input is split
    over "dp" (the twin's P("dp")): each shard runs the program over its
    B / dp streams on its device, one graph and one batched
    block-matching call per shard, and the outputs are gathered to the
    mesh's first device."""
    if stereo is not None and stereo not in STEREO_ROUTES:
        raise ValueError(f"stereo {stereo!r} not in {STEREO_ROUTES}")
    subs = tuple(dense_subs) if dense_subs is not None else DENSE_SUBS

    def vstep(frames, clouds, intens, valids, Js, R, t, actkey, poses,
              points, cand) -> FrontendStepOut:
        route = stereo or ("kernel" if frames.is_cuda else "twin")
        if route == "kernel":
            frames_f = normalize_frames(frames)
            smooth = torch.func.vmap(binomial3)
            disp = block_matching_disparity_bm_batched(
                smooth(frames_f[:, 0]), smooth(frames_f[:, 1]),
                num_disp=num_disp, radius=5)
            frames = torch.cat([frames_f, disp[:, None]], dim=1)
        use_ext, method = (True, 2) if route == "kernel" else (False, 1)

        def one(frames, clouds, intens, valids, Js, R, t, ak, poses, points,
                cand):
            return frontend_step(
                frames, clouds, intens, valids, Js, R, t, ak, poses, points,
                cand, cam_params, cam_statics, levels, num_disp, use_ext,
                max_reproj, method, dense_subs=subs)

        with lanes():
            return torch.func.vmap(one)(frames, clouds, intens, valids, Js,
                                        R, t, actkey, poses, points, cand)

    return OverDp(mesh, vstep, actkey_arg=7)


def build_multistream_mono(mesh, cam_params, cam_statics, levels=3,
                           zmssd_thr=0.18):
    """The per-frame monocular step over a batch of B streams:
    ``torch.func.vmap`` of one stream's ``mono_step`` over the stream
    axis, the twin's ``vstep``; on a card one CUDA graph replay per call.

    Returns step(imgs (B, H, W), R (B, 3, 3), t (B, 3), ak (B,), poses,
    points (tables with a leading B axis), Lam (B, P, 3, 3), cand (B, C),
    conv_thr (B,), prior_w (B,)) -> MonoStepOut with a leading stream axis
    on every leaf. With a mesh, every input is split over "dp", each
    shard's program runs on its device, and the outputs are gathered to
    the mesh's first device."""

    def one(img, R, t, ak, poses, points, Lam, cand, conv, pw):
        return mono_step(img, R, t, ak, poses, points, Lam, cand, conv, pw,
                         cam_params, cam_statics, levels, 2.0, zmssd_thr)

    def vstep(imgs, R, t, ak, poses, points, Lam, cand, conv, pw):
        with lanes():
            return torch.func.vmap(one)(imgs, R, t, ak, poses, points, Lam,
                                        cand, conv, pw)

    return OverDp(mesh, vstep, actkey_arg=3)

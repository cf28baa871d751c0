"""The benchmark's arithmetic: the end-to-end metrics from what a run
recorded, and frozen copies of chip_smoke.py's readers (commit 3511a3c):
``ate`` (``_ate``) and ``bound_ms`` (``_bound_ms``, with its constants),
verbatim but for their names.

ATE is taken under the alignment a configuration names under
``"ate_align"`` (``ALIGNMENTS``): ``"first_frame"``, the poses as
returned, in the first frame's gauge that the system and the generator
share (a stereo rig fixes the scale); ``"sim3"``, the camera centres
after the least-squares similarity onto the ground truth's (a monocular
run's scale and gauge are its own)."""

from __future__ import annotations

import numpy as np

# the bound of block matching: each cost entry (pixel x disparity) needs
# |L - R|, 10 horizontal adds, 10 vertical adds and ~3 compares (left
# view, runner-up, right view); the texture sum (<2% more) is left out.
# H100 SXM peaks: 67 TFLOP/s fp32 outside the tensor cores, 3.35 TB/s
# device memory.
OPS_PER_COST_ENTRY = 25
FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_ms(b, h, w, num_disp):
    """(least ms the card could take, "operations" or "bytes") for block
    matching B images of H x W at num_disp disparities: two f32 inputs
    read and one f32 output written once."""
    ops_ms = 1e3 * OPS_PER_COST_ENTRY * b * h * w * num_disp / FP32_OPS_PER_S
    bytes_ms = 1e3 * 3 * 4 * b * h * w / HBM_BYTES_PER_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def ate(est, gt):
    """RMSE (m) of the translation of Te @ Tg^-1 over paired poses: `est`
    with numpy R, t; `gt` with torch R, t (both world -> camera)."""
    errs = []
    for Te, Tg in zip(est, gt):
        Rg = Tg.R.numpy().astype(np.float64)
        tg = Tg.t.numpy().astype(np.float64)
        errs.append(Te.R @ (-Rg.T @ tg) + Te.t)  # translation of Te @ Tg^-1
    errs = np.stack(errs)
    return float(np.sqrt((errs ** 2).sum(axis=1).mean()))


def frames_per_s(n_poses: int, window_s: float) -> float:
    """Every pose returned inside the window over the window's wall time."""
    return n_poses / window_s


def p95(values) -> float:
    """The 95th percentile of all values (numpy's linear interpolation)."""
    return float(np.percentile(np.asarray(values, np.float64), 95.0))


def _over_prefix(rmse_of, trajectory, gt, ate_frames: int):
    pairs = sorted(((fid, T) for fid, T in trajectory if fid < ate_frames),
                   key=lambda e: e[0])
    if not pairs:
        return None, 0
    rmse = rmse_of([T for _, T in pairs], [gt[fid] for fid, _ in pairs])
    return rmse, len(pairs)


def prefix_ate(trajectory, gt, ate_frames: int):
    """ATE over the frames with id < `ate_frames` that the trajectory
    holds: (rmse, frames used). `trajectory` is [(frame_id, pose)], `gt`
    indexable by frame id."""
    return _over_prefix(ate, trajectory, gt, ate_frames)


def umeyama(src, dst):
    """(s, R, t) minimising sum_i |dst_i - (s R src_i + t)|^2 over
    similarities, for (n, 3) point sets: the closed form of S. Umeyama,
    "Least-squares estimation of transformation parameters between two
    point patterns", IEEE PAMI 13(4), 1991, eqs. (38)-(42)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(axis=0), dst.mean(axis=0)
    xs = src - src[0]  # so that equal points centre to exact zeros
    xs -= xs.mean(axis=0)
    xd = dst - mu_d
    var_s = (xs ** 2).sum(axis=1).mean()
    U, D, Vt = np.linalg.svd(xd.T @ xs / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    # all source points at one place: any scale fits, 0 maps them to the
    # destination's centroid
    s = float(np.trace(np.diag(D) @ S) / var_s) if var_s > 0 else 0.0
    return s, R, mu_d - s * R @ mu_s


def sim3_ate(est, gt):
    """RMSE (m) of the camera centres after the similarity that best maps
    the estimate's onto the ground truth's (`umeyama`); `est` and `gt` as
    in `ate`."""
    ce = np.stack([-T.R.T @ T.t for T in est])
    cg = np.stack([-Tg.R.numpy().astype(np.float64).T
                   @ Tg.t.numpy().astype(np.float64) for Tg in gt])
    s, R, t = umeyama(ce, cg)
    resid = cg - (s * ce @ R.T + t)
    return float(np.sqrt((resid ** 2).sum(axis=1).mean()))


def prefix_sim3_ate(trajectory, gt, ate_frames: int):
    """`prefix_ate` with the camera centres Sim3-aligned (`sim3_ate`)."""
    return _over_prefix(sim3_ate, trajectory, gt, ate_frames)


ALIGNMENTS = {"first_frame": prefix_ate, "sim3": prefix_sim3_ate}

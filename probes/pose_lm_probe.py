"""Where one frame step's pose differs between two runs of the port.

The frames are tests/test_torch_slam_system.py's 12 (the 256x192 camera,
the forward arc at step 0.05, stereo method 2), rendered once on the CPU
and quantized to uint8 (chip_smoke.parity_frames). Run from the root of a
checkout:

    python3 probes/pose_lm_probe.py card    # needs a CUDA card, no JAX
    python3 probes/pose_lm_probe.py starts  # on a CPU, needs JAX

``card``: a CPU frontend steps the frames; before each step its state is
loaded into a fresh frontend on the card and one on the CPU, which step the
same frame. One line per shared state: whether the pyramid and the
disparity are equal, the translation difference after each dense LM level
(coarse to fine) and each of the two motion-only LM rounds, their
iteration counts and chi2, the matched set, the gates and the final pose
difference. The last line is the card's name and power limit as
nvidia-smi reports them.

``starts``: the robust motion-only LM of each step of the CPU run (two
rounds per frame), started 12 times from its start pose moved by 1e-6
(a random SE3 tangent of that standard deviation): the largest spread of
the resulting translations, in the port and in the JAX package on the
same inputs, and the largest port-to-JAX difference from the same start.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from scavislam_tpu_torch import interop  # noqa: E402
from scavislam_tpu_torch.core.camera import StereoCamera  # noqa: E402
from scavislam_tpu_torch.core.lie import SE3  # noqa: E402
from scavislam_tpu_torch.models import frontend_step  # noqa: E402
from scavislam_tpu_torch.models.frontend import (  # noqa: E402
    CAND_CAP,
    StereoFrontend,
)
from scavislam_tpu_torch.utils.config import Config  # noqa: E402

# tests/test_torch_slam_system.py's camera and configuration
CAM = StereoCamera.create(195.0, (127.0, 95.0), (256, 192), 0.12)
N_FRAMES = 12
N_STARTS = 12
START_SIGMA = 1e-6


def frames(n=N_FRAMES):
    """The forward arc at step 0.05, rendered on the CPU, uint8."""
    return chip_smoke.parity_frames(CAM, n, step=0.05)


def config():
    c = Config()
    return dataclasses.replace(
        c, frontend=dataclasses.replace(c.frontend, covis_thr=10),
        ui=dataclasses.replace(c.ui, parallax_thr=0.12),
        graph=dataclasses.replace(c.graph, inner_window=5, outer_window=20))


def load_shared_state(fe, src, dev):
    """`src`'s (a CPU frontend's) state into `fe` on `dev`; returns fe."""
    n = lambda x: x.numpy()  # noqa: E731
    return interop.load_frontend_state(
        fe, poses=interop.pose_table(*(n(x) for x in src.poses), device=dev),
        points=interop.point_table(*(n(x) for x in src.points), device=dev),
        dense=interop.dense_state(
            [n(x) for x in src._prev_clouds], [n(x) for x in src._prev_intens],
            [n(x) for x in src._prev_valids], [n(x) for x in src._prev_J],
            device=dev),
        R_cw=n(src._dev_R_cw), t_cw=n(src._dev_t_cw), R_cak=src._R_cak,
        t_cak=src._t_cak, actkey_id=src.actkey_id, next_kf=src.next_kf,
        next_point=src.next_point, kf_point_ids=src.kf_point_ids,
        covis=src.covis, pose_np=src.pose_np, meta_anchor=src._meta_anchor,
        meta_level=src._meta_level, frame_id=src.frame_id)


def _recording(log):
    """Wrap the frame step's dense LM and motion-only LM to append each
    call's (stage, t, chi2, iterations) to `log`."""
    lm, ba = frontend_step._lm_level_ic, frontend_step.motion_only_ba

    def dense(*a, **k):
        out = lm(*a, **k)
        log.append(("dense", out[1].cpu().numpy(), float(out[2]),
                    int(out[3])))
        return out

    def motion(*a, **k):
        out = ba(*a, **k)
        log.append(("ba", out.T.t.cpu().numpy(), float(out.chi2), None))
        return out

    frontend_step._lm_level_ic, frontend_step.motion_only_ba = dense, motion


def card():
    dev = torch.device("cuda", 0)
    cfg = config()
    fs = frames()
    src = StereoFrontend(CAM, cfg, device="cpu")
    src.process_first_frame(fs[0])
    log = []
    _recording(log)
    for f in fs[1:]:
        runs = []
        for d in (dev, torch.device("cpu")):
            fe = load_shared_state(StereoFrontend(CAM, cfg, device=d), src,
                                   d)
            # eager: the recording reads each LM's result on the host
            fe._step = frontend_step.frontend_step
            log.clear()
            out = fe._run_step(f, fe._collect_candidates())
            runs.append((out, list(log)))
        (og, lg), (oc, lc) = runs
        equal = all(torch.equal(a.cpu(), b)
                    for a, b in zip(og.pyr + (og.disp,), oc.pyr + (oc.disp,)))
        pg, pc = og.packed.cpu().numpy(), oc.packed.numpy()
        C = CAND_CAP
        stages = ", ".join(
            f"{a[0]} {np.abs(a[1] - b[1]).max():.1e} (chi2 {a[2]:.4f}/"
            f"{b[2]:.4f}" + ("" if a[3] is None else f", iters {a[3]}/{b[3]}")
            + ")" for a, b in zip(lg, lc))
        print(f"frame {f['frame_id']}: pyramid and disparity equal {equal}; "
              f"t differences by stage {stages}; matched {int(pg[24])}/"
              f"{int(pc[24])}, gated {int(pg[25])}/{int(pc[25])}, matched "
              f"set and gates equal "
              f"{np.array_equal(pg[34:34 + 2 * C], pc[34:34 + 2 * C])}; "
              f"final pose max |diff| {np.abs(pg[:24] - pc[:24]).max():.2e}",
              flush=True)
        src.process_frame(f)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


def starts():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from scavislam_tpu.core import lie as jlie
    from scavislam_tpu.core.camera import StereoCamera as JCam
    from scavislam_tpu.models import pose_optimizer as jpo
    from scavislam_tpu_torch.models import pose_optimizer as tpo

    jcam = JCam.create(195.0, (127.0, 95.0), (256, 192), 0.12)
    fs = frames()
    fe = StereoFrontend(CAM, config(), device="cpu")
    fe.process_first_frame(fs[0])
    calls = []
    ba = frontend_step.motion_only_ba

    def recording(*a, **k):
        calls.append(a)
        return ba(*a, **k)

    frontend_step.motion_only_ba = recording
    rng = np.random.RandomState(0)
    for f in fs[1:]:
        calls.clear()
        fe.process_frame(f)
        for rnd, (cam, T0, xyz, obs, w, valid, delta) in enumerate(calls):
            tt, tj = [], []
            for _ in range(N_STARTS):
                d = SE3.exp(torch.as_tensor(rng.randn(6) * START_SIGMA,
                                            dtype=torch.float32))
                T = SE3(d.R @ T0.R, d.R @ T0.t + d.t)
                tt.append(tpo.motion_only_ba(cam, T, xyz, obs, w, valid,
                                             delta).T.t.numpy())
                rj = jpo.motion_only_ba(
                    jcam, jlie.SE3(jnp.asarray(T.R.numpy()),
                                   jnp.asarray(T.t.numpy())),
                    jnp.asarray(xyz.numpy()), jnp.asarray(obs.numpy()),
                    jnp.asarray(w.numpy()), jnp.asarray(valid.numpy()),
                    delta)
                tj.append(np.asarray(rj.T.t))
            tt, tj = np.stack(tt), np.stack(tj)
            print(f"frame {f['frame_id']} round {rnd + 1}: translation "
                  f"spread over {N_STARTS} starts {START_SIGMA:g} apart: port "
                  f"{np.abs(tt - tt[0]).max():.2e}, JAX "
                  f"{np.abs(tj - tj[0]).max():.2e}; port against JAX from "
                  f"the same start {np.abs(tt - tj).max():.2e}", flush=True)


if __name__ == "__main__":
    {"card": card, "starts": starts}[sys.argv[1]]()

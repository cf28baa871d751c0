"""Whole-system parity of the port with the JAX package on shared frames
(slow; CPU): the 360-degree spin of benchmarks/tpu_cpu_parity.py's "spin"
scene (256x192, 90 frames, closed box, covis_thr 10, parallax_thr 0.25,
windows 3 + 8), rendered once by the JAX renderer, written as a New
College-layout PNM tree and read through both packages' FileGrabbers.

Both SlamSystems run unthreaded and synchronous with loop closure on and
pr_lossless; the JAX side's pools run inline, and the port's recognizer
draws the JAX recognizer's RANSAC hypotheses (JaxDraws). Criteria: ATE
relative difference <= 1%; the same numbers of keyframes, DWO solves, and
METRIC and APPEARANCE edges. At stereo method 1 both run the cost-volume
twin; at method 2 the JAX package runs that twin on the CPU while the port
runs the block-matching kernel's plain version.

    python -m pytest tests/test_torch_system_parity.py -m slow -s
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from scavislam_tpu.core.camera import StereoCamera as JCam
from scavislam_tpu.io.filegrabber import FileGrabber as JFileGrabber
from scavislam_tpu.io.synthetic import SyntheticSequence, closed_box
from scavislam_tpu.models.slam_graph import APPEARANCE, METRIC
from scavislam_tpu.pipeline import slam_system as jss
from scavislam_tpu.utils.config import Config as JConfig
from scavislam_tpu_torch import interop
from scavislam_tpu_torch.io.filegrabber import FileGrabber
from scavislam_tpu_torch.pipeline import slam_system as tss
from scavislam_tpu_torch.utils.config import Config as TConfig
from test_torch_io import to_u8, write_newcollege_tree
from test_torch_placerec import JaxDraws
from test_torch_slam_system import _InlineExecutor

J_CAM = JCam.create(195.0, (127.0, 95.0), (256, 192), 0.12)
T_CAM = interop.camera(np.asarray(J_CAM.focal), np.asarray(J_CAM.pp),
                       J_CAM.size, np.asarray(J_CAM.baseline))
N_FRAMES = 90
REL_TOL = 0.01

pytestmark = pytest.mark.slow


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def spin_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("spin")
    seq = SyntheticSequence(J_CAM, n_frames=N_FRAMES, kind="spin",
                            planes=closed_box(), step=1.0 / (N_FRAMES - 1))
    pairs, gt = [], {}
    for i in range(N_FRAMES):
        f = seq.frame(i)
        pairs.append((to_u8(f["left"]), to_u8(f["right"])))
        gt[i] = (np.asarray(f["T_cw_gt"].R, np.float64),
                 np.asarray(f["T_cw_gt"].t, np.float64))
    write_newcollege_tree(str(root), pairs, 256, 192, 195.0, (127.0, 95.0),
                          0.12)
    return str(root), gt


def _cfg(cls, method):
    c = cls()
    return dataclasses.replace(
        c, frontend=dataclasses.replace(c.frontend, covis_thr=10),
        ui=dataclasses.replace(c.ui, parallax_thr=0.25, stereo_method=method),
        graph=dataclasses.replace(c.graph, inner_window=3, outer_window=8))


def _frames(grabber_cls, root):
    g = grabber_cls(root, base_pattern=".*rectified.*", fmt="pnm")
    frames = list(g)
    g.close()
    return frames


def _run(system, frames):
    if isinstance(system, jss.SlamSystem):
        system.frontend._fetch_pool = _InlineExecutor()
        system.backend.graph._fetch_pool = _InlineExecutor()
        system.backend._reg_pool = _InlineExecutor()
    else:
        system.place_recognizer.hypotheses = JaxDraws(jax.random.PRNGKey(42))
    system.process_first_frame(frames[0])
    for f in frames[1:]:
        assert system.process_frame(f), f["frame_id"]
    system.finish()
    system.shutdown()
    g = system.backend.graph
    types = [e.edge_type for e in g.edges.values()]
    return {
        "tracked": len(system.trajectory),
        "keyframes": system.frontend.next_kf,
        "solves": len(g.solve_log),
        "metric_edges": types.count(METRIC),
        "appearance_edges": types.count(APPEARANCE),
        "closed_loops": len(system.closed_loops),
        "trajectory": system.trajectory,
    }


@pytest.mark.parametrize("method", [1, 2])
def test_spin_parity_on_shared_frames(spin_tree, method):
    root, gt = spin_tree
    kw = dict(threaded=False, enable_loop_closure=True, pipelined=False,
              pr_lossless=True)
    j = _run(jss.SlamSystem(J_CAM, _cfg(JConfig, method), **kw),
             _frames(JFileGrabber, root))
    t = _run(tss.SlamSystem(T_CAM, _cfg(TConfig, method), device="cpu",
                            **kw), _frames(FileGrabber, root))
    for r, mod in ((j, jss), (t, tss)):
        r["ate"] = mod.ate_rmse(r["trajectory"],
                                [gt[fid] for fid, _ in r["trajectory"]])
    rel = abs(t["ate"] - j["ate"]) / j["ate"]
    keys = ("tracked", "keyframes", "solves", "metric_edges",
            "appearance_edges", "closed_loops", "ate")
    print("\nspin parity, stereo method", method, json.dumps({
        "jax": {k: j[k] for k in keys}, "port": {k: t[k] for k in keys},
        "ate_rel_diff": rel}))
    assert t["tracked"] == j["tracked"] == N_FRAMES
    assert rel <= REL_TOL, (t["ate"], j["ate"])
    for k in ("keyframes", "solves", "metric_edges", "appearance_edges"):
        assert t[k] == j[k], k

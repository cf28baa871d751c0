"""The port's command line (apps/stereo_slam) and the RGB-D dump replay, on
the CPU: the CLI over a mock New College tree against the JAX package's
SlamSystem on the same files (held as tests/test_torch_slam_system.py holds
the systems: the same keyframes, ATE within max(1% of JAX's, 1e-4 m)), the
pipelined CLI with the grabber's prefetch, tests/test_full_system.py's
RGB-D replay through the port's recorder and grabber, the synthetic and
multistream paths (on one device and over a dp mesh), the checkpoint and
export flags, and the viewer flags."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from scavislam_tpu.apps.stereo_slam import build_camera as jbuild_camera
from scavislam_tpu.io.filegrabber import FileGrabber as JFileGrabber
from scavislam_tpu.pipeline import slam_system as jss
from scavislam_tpu.utils.config import load_config as jload_config
from scavislam_tpu_torch.apps import stereo_slam
from scavislam_tpu_torch.apps.dump_sequence import record
from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.core.lie import SO3, PoseRT
from scavislam_tpu_torch.io.filegrabber import FileGrabber
from scavislam_tpu_torch.io.synthetic import SyntheticSequence
from scavislam_tpu_torch.pipeline.slam_system import SlamSystem, ate_rmse
from scavislam_tpu_torch.utils.config import Config
from test_torch_io import to_u8, write_newcollege_tree
from test_torch_slam_system import _InlineExecutor

CAM = StereoCamera.create(195.0, (127.0, 95.0), (256, 192), 0.12)
N_FRAMES = 10
CPU = "cpu"
# tests/test_newcollege_ingest.py's run-time knobs, as cfg lines
EXTRA_CFG = ("ui_parallax_thr = 0.25;\ngraph.inner_window = 5;\n"
             "graph.outer_window = 20;\n")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The mock New College tree (rendered once by the port) and its
    ground truth."""
    root = tmp_path_factory.mktemp("newcollege")
    seq = SyntheticSequence(CAM, n_frames=N_FRAMES, step=0.01, device=CPU)
    frames = [seq.frame(i) for i in range(N_FRAMES)]
    cfg = write_newcollege_tree(
        str(root), [(to_u8(f["left"]), to_u8(f["right"])) for f in frames],
        256, 192, 195.0, (127.0, 95.0), 0.12)
    with open(cfg, "a") as fh:
        fh.write(EXTRA_CFG)
    return root, cfg, {i: f["T_cw_gt"] for i, f in enumerate(frames)}


def read_trajectory(path):
    """The CLI's trajectory file -> [(frame_id, PoseRT T_cw)]."""
    rows = np.atleast_2d(np.loadtxt(path))
    R = SO3.exp(torch.as_tensor(rows[:, 4:7], dtype=torch.float32)).R
    return [(int(r[0]), PoseRT(R[k].numpy().astype(np.float64), r[1:4]))
            for k, r in enumerate(rows)]


def _ate(traj, gt):
    return ate_rmse(traj, [gt[fid] for fid, _ in traj])


def _cli(tmp_path, *args):
    out = str(tmp_path / "traj.txt")
    summary = stereo_slam.main([*args, "--device", CPU, "--out", out])
    return summary, read_trajectory(out)


@pytest.fixture(scope="module")
def cli_run(tree, tmp_path_factory):
    _root, cfg, gt = tree
    tmp = tmp_path_factory.mktemp("cli")
    return _cli(tmp, cfg, "--no-loop-closure")


def test_cli_runs_newcollege_tree(cli_run, tree, capsys):
    summary, traj = cli_run
    gt = tree[2]
    assert summary["frames_processed"] == N_FRAMES
    assert summary["keyframes"] >= 1 and summary["map_points"] > 0
    assert [fid for fid, _ in traj] == list(range(N_FRAMES))
    assert _ate(traj, gt) < 0.05
    assert summary["frames_per_s"] > 0 and summary["grab_wait_ms"] >= 0
    assert "ate_rmse_m" not in summary  # no ground truth on disk


def test_cli_matches_jax_system_on_the_tree(cli_run, tree):
    """The JAX SlamSystem on the same files through its own grabber,
    unthreaded, loop closure off, its pools inline."""
    summary, traj = cli_run
    _root, cfg_path, gt = tree
    cfg = jload_config(cfg_path)
    g = JFileGrabber(cfg.framepipe.path_str,
                     base_pattern=cfg.framepipe.base_str,
                     fmt=cfg.framepipe.format_str,
                     right_img=cfg.framepipe.right_img)
    frames = list(g)
    g.close()
    js = jss.SlamSystem(jbuild_camera(cfg), cfg, threaded=False,
                        enable_loop_closure=False)
    js.frontend._fetch_pool = _InlineExecutor()
    js.backend.graph._fetch_pool = _InlineExecutor()
    js.backend._reg_pool = _InlineExecutor()
    js.process_first_frame(frames[0])
    for f in frames[1:]:
        assert js.process_frame(f)
    js.finish()
    js.shutdown()
    assert summary["keyframes"] == len(js.frontend.keyframe_map)
    assert [fid for fid, _ in traj] == [fid for fid, _ in js.trajectory]
    a_j = jss.ate_rmse(js.trajectory, [gt[fid] for fid, _ in js.trajectory])
    a_t = _ate(traj, gt)
    assert abs(a_t - a_j) <= max(0.01 * a_j, 1e-4), (a_t, a_j)


def test_cli_pipelined_with_prefetch(tree, tmp_path):
    # --pipelined: the grabber stacks every frame (device_prefetch) and the
    # frontend takes the stack in place; loop closure on, the default
    _root, cfg, gt = tree
    summary, traj = _cli(tmp_path, cfg, "--pipelined", "--pipeline-depth",
                         "2")
    assert summary["frames_processed"] == N_FRAMES
    assert sorted(fid for fid, _ in traj) == list(range(N_FRAMES))
    assert _ate(traj, gt) < 0.05


def test_cli_synthetic(tree, tmp_path):
    _root, cfg, _gt = tree
    summary, traj = _cli(tmp_path, cfg, "--synthetic", "6",
                         "--no-loop-closure")
    assert summary["frames_processed"] == 6 and len(traj) == 6
    assert summary["ate_rmse_m"] < 0.05


def test_cli_stereo_method_4(tree, tmp_path):
    # a .cfg that selects constant-space BP runs through the CLI: every
    # frame tracked within the CLI tests' bar
    _root, cfg, gt = tree
    cfg4 = tmp_path / "csbp.cfg"
    with open(cfg) as fh:
        cfg4.write_text(fh.read() + "ui.stereo_method = 4;\n")
    assert stereo_slam.load_config(str(cfg4)).ui.stereo_method == 4
    summary, traj = _cli(tmp_path, str(cfg4), "--max-frames", "6",
                         "--no-loop-closure")
    assert summary["frames_processed"] == 6
    assert sorted(fid for fid, _ in traj) == list(range(6))
    assert _ate(traj, gt) < 0.05


def test_cli_max_frames(tree, tmp_path):
    _root, cfg, _gt = tree
    summary, traj = _cli(tmp_path, cfg, "--max-frames", "4",
                         "--no-loop-closure")
    assert summary["frames_processed"] == 4 and len(traj) == 4


def test_cli_streams(tree, tmp_path, capsys):
    _root, cfg, _gt = tree
    out = tmp_path / "traj.txt"
    summary = stereo_slam.main([cfg, "--streams", "2", "--synthetic", "5",
                                "--device", CPU, "--out", str(out)])
    assert [s["alive"] for s in summary["per_stream"]] == [True, True]
    assert [s["frames"] for s in summary["per_stream"]] == [5, 5]
    assert (tmp_path / "traj_s1.txt").exists()
    assert json.loads(capsys.readouterr().out)["streams"] == 2


def test_cli_streams_mesh(tree, tmp_path):
    """--streams-mesh 2 on the CPU: the two streams split over a dp = 2
    mesh of the CPU device, reported as the twin reports it."""
    _root, cfg, _gt = tree
    summary = stereo_slam.main([cfg, "--streams", "2", "--streams-mesh", "2",
                                "--synthetic", "3", "--device", CPU,
                                "--out", str(tmp_path / "traj.txt")])
    assert summary["mesh"] == {"dp": 2, "sp": 1}
    assert [s["alive"] for s in summary["per_stream"]] == [True, True]
    assert [s["frames"] for s in summary["per_stream"]] == [3, 3]


def test_cli_defaults_to_the_card(tree, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        stereo_slam.main([tree[1]])


@pytest.fixture(scope="module")
def viewer_run(tree, tmp_path_factory):
    """The CLI over the tree's first 6 frames with every viewer flag; the
    watch directory holds a tunables.cfg before the run (debug_mode = 3),
    which the running system must read."""
    _root, cfg, _gt = tree
    tmp = tmp_path_factory.mktemp("viewers")
    watch = tmp / "watch"
    watch.mkdir()
    (watch / "tunables.cfg").write_text("debug_mode = 3\n")
    paths = {"viz": tmp / "map.png", "viz_html": tmp / "map3d.html",
             "timing_plot": tmp / "timing.png",
             "keyframe_view": tmp / "kf.png"}
    args = [cfg, "--max-frames", "6", "--debug-mode", "6", "--debug-every",
            "2", "--debug-out", str(tmp / "debug"), "--watch", str(watch),
            "--watch-period", "0"]
    for flag, p in paths.items():
        args += ["--" + flag.replace("_", "-"), str(p)]
    summary, _traj = _cli(tmp, *args)
    return tmp, paths, summary


@pytest.mark.parametrize("flag", ["debug_mode", "keyframe_view", "timing_plot",
                                  "viz", "viz_html", "watch"])
def test_viewer_flag_writes_its_artifact(viewer_run, flag):
    """Each viewer flag (refused until apps/visualize.py, map3d.py and
    watch.py were ported) writes its artifact."""
    from scavislam_tpu_torch.utils.png import decode_png

    tmp, paths, summary = viewer_run
    assert summary["frames_processed"] == 6
    if flag == "debug_mode":
        names = sorted(os.listdir(tmp / "debug"))
        assert names == [f"debug_{n:06d}.png" for n in (0, 2, 4)]
        img = decode_png((tmp / "debug" / names[-1]).read_bytes())
        assert img.shape == (192, 256, 3) and img.max() > 0
    elif flag == "watch":
        for name in ("map.png", "map3d.html", "timing.png", "debug.png",
                     "status.json"):
            assert (tmp / "watch" / name).exists(), name
        status = json.loads((tmp / "watch" / "status.json").read_text())
        assert status["frame"] == 5 and status["debug_mode"] == 3
    elif flag == "viz_html":
        html = paths[flag].read_text()
        scene = json.loads(html.split("const SCENE = ", 1)[1]
                           .split(";\n", 1)[0])
        assert len(scene["kf_ids"]) == summary["keyframes"] >= 1
    else:
        img = decode_png(paths[flag].read_bytes())
        assert img.ndim == 3 and img.shape[2] == 3
        if flag == "keyframe_view":
            assert img.shape == (192, 256, 3)


def _small_cfg():
    cfg = Config()
    return dataclasses.replace(
        cfg,
        frontend=dataclasses.replace(cfg.frontend, covis_thr=10),
        ui=dataclasses.replace(cfg.ui, parallax_thr=0.25),
        graph=dataclasses.replace(cfg.graph, inner_window=5, outer_window=20))


@pytest.mark.parametrize("prefetch", [False, True],
                         ids=["host", "device_prefetch"])
def test_rgbd_dump_and_replay(tmp_path, prefetch):
    """tests/test_full_system.py's RGB-D replay on the port: record with
    exact disparity, replay through the FileGrabber, track on the external
    disparity (no stereo matching)."""
    n = 6
    seq = SyntheticSequence(CAM, n_frames=n, step=0.02, device=CPU)
    assert record(iter(seq), str(tmp_path), with_disp=True) == n
    grabber = FileGrabber(str(tmp_path), base_pattern="img_.*", fmt="png",
                          right_img=True, disp_img=True,
                          device_prefetch=prefetch, device=CPU)
    assert len(grabber) == n
    system = SlamSystem(CAM, _small_cfg(), threaded=False,
                        enable_loop_closure=False, device=CPU)
    fids = []
    for i, f in enumerate(grabber):
        assert f["disp"].shape == (192, 256)
        assert ("stacked_dev" in f) == prefetch
        if i == 0:
            system.process_first_frame(f)
        else:
            assert system.process_frame(f), f"lost at {i}"
        fids.append(f["frame_id"])
    grabber.close()
    system.shutdown()
    assert fids == list(range(n))
    gt = [seq.frame(j)["T_cw_gt"] for j in fids]
    errs = [np.linalg.norm((PoseRT.from_any(T)
                            @ PoseRT.from_any(g).inverse()).t)
            for (_, T), g in zip(system.trajectory, gt)]
    assert float(np.sqrt(np.mean(np.square(errs)))) < 0.03


@pytest.fixture(scope="module")
def saved_run(tree, tmp_path_factory):
    """The CLI over the tree's first 6 frames with the four checkpoint and
    export flags (utils/serialization.py)."""
    _root, cfg, _gt = tree
    tmp = tmp_path_factory.mktemp("saved")
    paths = {"save_map": str(tmp / "map.npz"),
             "save_system": str(tmp / "system.npz"),
             "save_traj_tum": str(tmp / "traj_tum.txt")}
    args = [cfg, "--max-frames", "6"]
    for flag, p in paths.items():
        args += ["--" + flag.replace("_", "-"), p]
    summary, traj = _cli(tmp, *args)
    return tmp, paths, summary, traj


@pytest.mark.parametrize("flag", ["save_map", "save_system", "load_system",
                                  "save_traj_tum"])
def test_serialization_flag(tree, saved_run, flag):
    # the four flags the CLI refused until utils/serialization.py was
    # ported: each writes (or reads) a checkpoint the port's loaders take
    from scavislam_tpu_torch.utils import serialization

    tmp, paths, summary, traj = saved_run
    assert summary["frames_processed"] == 6
    if flag == "save_map":
        g = serialization.load_graph(paths[flag], CAM, device=CPU)
        assert len(g.vertices) == summary["keyframes"] >= 1
        assert len(g.points) > 0
    elif flag == "save_traj_tum":
        rows = np.atleast_2d(np.loadtxt(paths[flag]))
        assert rows.shape == (6, 8)
        assert [int(r) for r in rows[:, 0]] == [fid for fid, _ in traj]
        np.testing.assert_allclose(np.linalg.norm(rows[:, 4:8], axis=1), 1.0,
                                   atol=1e-5)
    elif flag == "save_system":
        s = serialization.load_system(paths[flag], CAM, threaded=False,
                                      device=CPU)
        try:
            assert s.lost
            assert len(s.place_recognizer.location_map) >= 1
            assert len(s.backend.graph.vertices) == summary["keyframes"]
        finally:
            s.shutdown()
    else:
        # resume from the saved system on the same tree: the run starts in
        # lost mode, relocalizes against the loaded map and tracks on
        summary2, traj2 = _cli(tmp, tree[1], "--load-system",
                               paths["save_system"], "--max-frames", "4")
        assert summary2["frames_processed"] == 4
        assert len(traj2) >= 2
        assert _ate(traj2[1:], tree[2]) < 0.05

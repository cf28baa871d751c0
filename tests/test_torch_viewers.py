"""The port's viewers (apps/visualize, apps/map3d, apps/watch), its PNG
writer, the vocabulary trainer (apps/create_dictionary) and the viewer flags
of the command lines, against the JAX package on the CPU.

- Drawings: the twin's ``ImageDraw.Draw`` is wrapped in a recorder, so that
  its calls can be compared with the port's primitive list (same kinds and
  order, coordinates within 1e-3 px); the rasterized images are compared
  pixel for pixel with PIL's outside text boxes. Measured: every pixel
  equal (the rasterizer follows PIL's integer rules; 300 random points,
  lines of widths 1 and 2, ellipses and rectangles each agreed exactly
  with PIL 12.1), so the tolerance is 0 differing pixels outside text.
- The device-side views (``_to_img``, ``disparity_hsv``, ``residual_image``
  and the 7 debug modes) from one state, the JAX frontend's debug arrays
  carried into a port frontend through ``interop``: within 1 per channel
  on every pixel.
- map3d: ``extract_scene`` equal and ``export_map_html`` byte-identical on
  tests/test_aux.py's scene; the Watcher on test_aux.py's protocol.
- The mirrored cases of tests/test_aux.py's TestVisualize, TestWatch,
  TestMap3d, TestDictionaryBuilder and TestStereoSlamCli, on the port.
"""

import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import ImageDraw

from scavislam_tpu.apps import map3d as jmap3d
from scavislam_tpu.apps import visualize as jviz
from scavislam_tpu.core.camera import StereoCamera as JCam
from scavislam_tpu.core.lie import SE3 as JSE3
from scavislam_tpu.io.synthetic import SyntheticSequence as JSeq
from scavislam_tpu.models.frontend import StereoFrontend as JFrontend
from scavislam_tpu.models.slam_graph import APPEARANCE as J_APPEARANCE
from scavislam_tpu.models.slam_graph import LOCAL as J_LOCAL
from scavislam_tpu.utils.config import Config as JConfig
from scavislam_tpu.utils.perfmon import PerformanceMonitor as JPerfMon
from scavislam_tpu_torch import interop
from scavislam_tpu_torch.apps import map3d, visualize
from scavislam_tpu_torch.models.frontend import StereoFrontend
from scavislam_tpu_torch.utils.config import Config
from scavislam_tpu_torch.utils.perfmon import PerformanceMonitor
from scavislam_tpu_torch.utils.png import decode_png, encode_png, write_png

sys.path.insert(0, os.path.dirname(__file__))
from test_slam_graph import build_graph, gt_pose  # noqa: E402

J_CAM = JCam.create(195.0, (127.0, 95.0), (256, 192), 0.12)
T_CAM = interop.camera(np.asarray(J_CAM.focal), np.asarray(J_CAM.pp),
                       J_CAM.size, np.asarray(J_CAM.baseline))
CPU = "cpu"
COORD_TOL = 1e-3  # px, primitive coordinates
_PIL_DRAW = ImageDraw.Draw  # the recorder patches the module's attribute


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the twin's drawing calls ---------------------------------------------- #

def _pairs(xy):
    a = [float(v) for v in np.asarray(xy, np.float64).reshape(-1)]
    return tuple(zip(a[0::2], a[1::2]))


class _Recorder:
    """ImageDraw.Draw that records every call as a visualize.Prim-like
    tuple (kind, pairs, fill, outline, width, text) and the pixel box of
    each text, then draws as PIL does."""

    def __init__(self, img, log, text_boxes):
        self._d = _PIL_DRAW(img)
        self._log = log
        self._boxes = text_boxes

    def point(self, xy, fill=None):
        self._log.append(("point", _pairs(xy), fill, None, 1, None))
        self._d.point(xy, fill=fill)

    def line(self, xy, fill=None, width=1):
        self._log.append(("line", _pairs(xy), fill, None, width, None))
        self._d.line(xy, fill=fill, width=width)

    def ellipse(self, xy, fill=None, outline=None):
        self._log.append(("ellipse", _pairs(xy), fill, outline, 1, None))
        self._d.ellipse(xy, fill=fill, outline=outline)

    def rectangle(self, xy, fill=None):
        self._log.append(("rectangle", _pairs(xy), fill, None, 1, None))
        self._d.rectangle(xy, fill=fill)

    def text(self, xy, text, fill=None):
        self._log.append(("text", _pairs(xy), fill, None, 1, text))
        self._boxes.append(self._d.textbbox(xy, text))
        self._d.text(xy, text, fill=fill)


@pytest.fixture
def recorded(monkeypatch):
    """(calls, text boxes) of the twin's drawings while the test runs."""
    log, boxes = [], []
    monkeypatch.setattr(jviz.ImageDraw, "Draw",
                        lambda img: _Recorder(img, log, boxes))
    return log, boxes


def _assert_prims_equal(ours, theirs):
    assert len(ours) == len(theirs)
    for p, (kind, xy, fill, outline, width, text) in zip(ours, theirs):
        assert p.kind == kind
        assert p.fill == fill and p.outline == outline
        assert p.width == width and p.text == text
        np.testing.assert_allclose(np.asarray(p.xy, np.float64),
                                   np.asarray(xy, np.float64), atol=COORD_TOL)


def _text_mask(shape, prims, boxes):
    """Pixels inside any text box, PIL's or the port's 5x7 font's."""
    m = np.zeros(shape[:2], bool)
    for x0, y0, x1, y1 in boxes:
        m[max(int(y0) - 1, 0):int(y1) + 2, max(int(x0) - 1, 0):int(x1) + 2] = 1
    for p in prims:
        if p.kind == "text":
            (x, y), = p.xy
            m[max(int(y) - 1, 0):int(y) + 9,
              max(int(x) - 1, 0):int(x) + 6 * len(p.text) + 2] = 1
    return m


# -- drawings against the twin --------------------------------------------- #

def test_map_topdown_matches_twin(recorded):
    log, _ = recorded
    g, _ = build_graph(6)
    traj = [(i, gt_pose(i)) for i in range(6)]
    gts = [gt_pose(i) for i in range(6)]
    j_img = np.asarray(jviz.render_map_topdown(g, trajectory=traj,
                                               gt_poses=gts))
    prims = visualize.map_topdown_prims(g, traj, gts)
    _assert_prims_equal(prims, log)
    assert {p.kind for p in prims} == {"point", "line", "ellipse"}
    img = visualize.render_map_topdown(g, trajectory=traj, gt_poses=gts)
    assert img.shape == (900, 900, 3) and img.dtype == np.uint8
    np.testing.assert_array_equal(img, j_img)


def test_frame_overlay_matches_twin(recorded):
    log, _ = recorded
    rng = np.random.RandomState(3)
    left = rng.rand(192, 256).astype(np.float32)
    uv = rng.rand(40, 2) * [256, 192]
    corners = rng.rand(60, 2) * [256, 192]
    j_img = np.asarray(jviz.render_frame_overlay(left, tracked_uv=uv,
                                                 corners_uv=corners))
    _assert_prims_equal(visualize.overlay_prims(uv, corners), log)
    img = visualize.render_frame_overlay(torch.as_tensor(left),
                                         tracked_uv=uv, corners_uv=corners)
    np.testing.assert_array_equal(img, j_img)


def _timing_monitors():
    """A twin and a port PerformanceMonitor with the same history."""
    rng = np.random.RandomState(1)
    mons = (JPerfMon(), PerformanceMonitor())
    names = ["frontend", "backend", "place_recognition", "idle"]
    hist = [{n: float(rng.rand() * 0.02) for n in names[:3]}
            for _ in range(40)]
    for m in mons:
        for n in names:
            m.add(n)
        m.history = [dict(h) for h in hist]
    return mons


def test_timing_plot_matches_twin(recorded):
    log, boxes = recorded
    jm, tm = _timing_monitors()
    j_img = np.asarray(jviz.render_timing_plot(jm))
    prims = visualize.timing_prims(tm)
    _assert_prims_equal(prims, log)
    img = visualize.render_timing_plot(tm)
    assert img.shape == (360, 900, 3)
    outside = ~_text_mask(img.shape, prims, boxes)
    assert outside.mean() > 0.9
    np.testing.assert_array_equal(img[outside], j_img[outside])
    # the port's labels are drawn: some text pixels differ from the
    # background
    assert (img[~outside] != visualize.BACKGROUND).any()


def test_png_writer_roundtrip(tmp_path):
    rng = np.random.RandomState(0)
    for shape in ((5, 7), (6, 4, 3), (3, 9, 4)):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        np.testing.assert_array_equal(decode_png(encode_png(img)), img)
    p = str(tmp_path / "x.png")
    write_png(p, img)
    with open(p, "rb") as f:
        np.testing.assert_array_equal(decode_png(f.read()), img)
    with pytest.raises(ValueError):
        decode_png(b"not a png")


# -- device-side views against the twin ------------------------------------- #

def test_to_img_matches_twin():
    rng = np.random.RandomState(2)
    for a in (rng.randn(48, 64).astype(np.float32),
              rng.rand(48, 64, 3).astype(np.float32) * 1.2 - 0.1):
        j = np.asarray(jviz._to_img(a)).astype(int)
        t = visualize._to_img(torch.as_tensor(a)).astype(int)
        assert np.abs(j - t).max() <= 1


@pytest.mark.parametrize("num_disp", [16, 64])
def test_disparity_hsv_matches_twin(num_disp):
    rng = np.random.RandomState(num_disp)
    d = (rng.rand(48, 64) * num_disp * 1.1 - 2).astype(np.float32)
    d[rng.rand(48, 64) < 0.2] = -1.0
    j = np.asarray(jviz.disparity_hsv(d, num_disp)).astype(int)
    t = visualize.disparity_hsv(torch.as_tensor(d), num_disp).astype(int)
    assert np.abs(j - t).max() <= 1
    # lit pixels are exactly the valid ones
    np.testing.assert_array_equal(t.max(-1) > 0, d > 0)


def test_residual_image_matches_twin():
    rng = np.random.RandomState(7)
    img = rng.rand(48, 64).astype(np.float32)
    n = 500
    X = np.stack([rng.randn(n) * 0.8, rng.randn(n) * 0.6,
                  rng.rand(n) * 4 + 0.5], -1).astype(np.float32)
    X[:20, 2] = -1.0  # behind the camera: out of view
    intens = rng.rand(n).astype(np.float32)
    valid = rng.rand(n) < 0.8
    R = np.asarray(JSE3.exp(jnp.asarray([0.01, -0.02, 0.03, 0.02, 0.01,
                                         -0.01])).R)
    t = np.array([0.01, 0.02, -0.03], np.float32)
    cam = J_CAM.scale_level(2)
    j = np.asarray(jviz.residual_image(cam, img, X, intens, valid, R, t))
    tc = interop.camera(np.asarray(cam.focal), np.asarray(cam.pp), cam.size,
                        np.asarray(cam.baseline))
    out = visualize.residual_image(tc, torch.as_tensor(img), X, intens,
                                   valid, R, t)
    assert np.abs(j.astype(int) - out.astype(int)).max() <= 1
    # blue pixels: out-of-view points were drawn
    assert ((out[..., 2] == 255) & (out[..., 0] == 51)).any()


@pytest.fixture(scope="module")
def twin_frontend():
    """The JAX frontend after 3 frames with keyframe images kept, and a
    port frontend carrying its debug state through interop."""
    seq = JSeq(J_CAM, n_frames=3, step=0.02)
    jfe = JFrontend(J_CAM, JConfig())
    jfe.keep_kf_images = True
    jfe.process_first_frame(seq.frame(0))
    for i in (1, 2):
        ok, _ = jfe.process_frame(seq.frame(i))
        assert ok
    fe = StereoFrontend(T_CAM, Config(), device=CPU)

    def tup(xs):
        return tuple(interop.tensor(x) for x in xs)

    fe.last_pyr = tup(jfe.last_pyr)
    fe.prev_pyr = tup(jfe.prev_pyr)
    fe.last_dx, fe.last_dy = tup(jfe.last_dx), tup(jfe.last_dy)
    fe.last_disp = interop.tensor(jfe.last_disp)
    fe.last_right = interop.tensor(jfe.last_right)
    (fe._prev_clouds, fe._prev_intens, fe._prev_valids,
     fe._prev_J) = interop.dense_state(jfe._prev_clouds, jfe._prev_intens,
                                       jfe._prev_valids, jfe._prev_J)
    p = jfe.points
    fe.points = interop.point_table(p.psi, p.anchor, p.level, p.patch, p.uv0,
                                    p.valid)
    fe.kf_point_ids = {k: np.asarray(v) for k, v in jfe.kf_point_ids.items()}
    fe._meta_anchor = np.asarray(jfe._meta_anchor).copy()
    fe.keyframe_map = {k: {"T_kw": v["T_kw"], "pyr": tup(v["pyr"]),
                           "disp": interop.tensor(v["disp"])}
                       for k, v in jfe.keyframe_map.items()}
    return jfe, fe


@pytest.mark.parametrize("mode", range(len(visualize.DEBUG_MODES)))
def test_debug_mode_matches_twin(twin_frontend, mode, tmp_path):
    jfe, fe = twin_frontend
    for level in (0, 2):
        j = np.asarray(jviz.render_debug_image(mode, level, jfe)).astype(int)
        p = str(tmp_path / f"dbg{mode}_{level}.png")
        t = visualize.render_debug_image(mode, level, fe, path=p)
        full = level == 0 or visualize.DEBUG_MODES[mode] in ("right",
                                                             "color_disp")
        assert t.shape == ((192, 256, 3) if full else (48, 64, 3))
        assert np.abs(j - t.astype(int)).max() <= 1, visualize.DEBUG_MODES[mode]
        with open(p, "rb") as f:
            np.testing.assert_array_equal(decode_png(f.read()), t)


def test_keyframe_view_matches_twin(twin_frontend, recorded):
    log, _ = recorded
    jfe, fe = twin_frontend
    j_img = np.asarray(jviz.render_keyframe_view(jfe, 0))
    prims = visualize.keyframe_prims(fe, 0)
    assert len(prims) > 20
    _assert_prims_equal(prims, log)
    img = visualize.render_keyframe_view(fe, 0)
    np.testing.assert_array_equal(img, j_img)
    fe2 = StereoFrontend(T_CAM, Config(), device=CPU)
    fe2.keyframe_map = {0: {"T_kw": None}}
    with pytest.raises(KeyError, match="keep_kf_images = True"):
        visualize.render_keyframe_view(fe2, 0)


# -- map3d ------------------------------------------------------------------ #

def _map3d_scene():
    """tests/test_aux.py:299-359's scene (the port's edge types equal the
    twin's)."""
    rng = np.random.RandomState(5)
    T0 = JSE3.exp(np.array([0.1, -0.2, 0.3, 0.04, -0.02, 0.05], np.float32))
    T1 = JSE3.exp(np.array([-0.3, 0.1, 0.6, -0.03, 0.06, 0.01], np.float32))
    vert = {k: types.SimpleNamespace(R=np.asarray(T.R, np.float64),
                                     t=np.asarray(T.t, np.float64))
            for k, T in ((0, T0), (7, T1))}
    xyz_w = rng.randn(3) + np.array([0.0, 0.0, 4.0])
    xyz_a = vert[0].R @ xyz_w + vert[0].t
    psi = np.array([xyz_a[0] / xyz_a[2], xyz_a[1] / xyz_a[2], 1.0 / xyz_a[2]])
    points = {3: types.SimpleNamespace(anchor_id=0, psi=psi),
              4: types.SimpleNamespace(anchor_id=99, psi=psi)}
    edges = {
        (0, 7): types.SimpleNamespace(edge_type=J_LOCAL,
                                      is_marginalized=lambda: True),
        (7, 0): types.SimpleNamespace(edge_type=J_APPEARANCE,
                                      is_marginalized=lambda: False),
    }
    traj = [(i, gt_pose(i)) for i in range(3)]
    return (types.SimpleNamespace(vertices=vert, points=points, edges=edges),
            xyz_w, traj)


def test_map3d_matches_twin(tmp_path):
    graph, _xyz, traj = _map3d_scene()
    kw = dict(trajectory=traj, gt_poses=[T for _, T in traj], actkey_id=7)
    assert (map3d.extract_scene(graph, **kw)
            == jmap3d.extract_scene(graph, **kw))
    pj, pt = str(tmp_path / "j.html"), str(tmp_path / "t.html")
    jmap3d.export_map_html(graph, path=pj, **kw)
    map3d.export_map_html(graph, path=pt, **kw)
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()


def test_map3d_scene_geometry_and_html_export(tmp_path):
    """test_aux.py::TestMap3d on the port."""
    graph, xyz_w, _ = _map3d_scene()
    scene = map3d.extract_scene(graph, actkey_id=7)
    assert scene["kf_ids"] == [0, 7]
    assert scene["actkey"] == 1
    v0 = graph.vertices[0]
    np.testing.assert_allclose(scene["kf_centers"][0], -v0.R.T @ v0.t,
                               atol=1e-3)
    assert len(scene["points"]) == 1
    np.testing.assert_allclose(scene["points"][0], xyz_w, atol=2e-3)
    assert sorted(e[2:] for e in scene["edges"]) == sorted(
        [[int(J_LOCAL), 1], [int(J_APPEARANCE), 0]])
    out = str(tmp_path / "m.html")
    map3d.export_map_html(graph, path=out, actkey_id=7)
    html = open(out).read()
    assert "<canvas" in html and "localStorage" in html
    assert "http://" not in html and "https://" not in html
    payload = html.split("const SCENE = ", 1)[1].split(";\n", 1)[0]
    assert json.loads(payload)["kf_ids"] == [0, 7]
    assert not os.path.exists(out + ".tmp")


# -- test_aux.py's TestVisualize on the port --------------------------------- #

def test_render_map(tmp_path):
    g, _ = build_graph(6)
    traj = [(i, gt_pose(i)) for i in range(6)]
    p = str(tmp_path / "map.png")
    img = visualize.render_map_topdown(
        g, trajectory=traj, gt_poses=[gt_pose(i) for i in range(6)], path=p)
    assert img.shape == (900, 900, 3)
    with open(p, "rb") as f:
        np.testing.assert_array_equal(decode_png(f.read()), img)
    p2 = str(tmp_path / "frame.png")
    visualize.render_frame_overlay(
        np.random.rand(192, 256),
        tracked_uv=np.array([[10.0, 20.0], [100.0, 90.0]]), path=p2)
    assert os.path.exists(p2)


@pytest.fixture(scope="module")
def port_system():
    """The port's unthreaded SlamSystem after 3 frames, keyframe images
    kept (test_aux.py's TestVisualize setup)."""
    from scavislam_tpu_torch.io.synthetic import SyntheticSequence
    from scavislam_tpu_torch.pipeline.slam_system import SlamSystem

    seq = SyntheticSequence(T_CAM, n_frames=4, step=0.02, device=CPU)
    system = SlamSystem(T_CAM, Config(), threaded=False,
                        enable_loop_closure=False, device=CPU)
    system.frontend.keep_kf_images = True
    system.process_first_frame(seq.frame(0))
    for i in (1, 2):
        assert system.process_frame(seq.frame(i))
    yield system, seq
    system.shutdown()


def test_debug_views_and_timing_plot(port_system, tmp_path):
    system, _ = port_system
    fe = system.frontend
    assert fe.prev_pyr is not None and fe.last_right is not None
    assert fe.draw_data.tracked_uv.shape[1] == 2
    assert len(fe.draw_data.tracked_uv) > 20
    for mode in range(len(visualize.DEBUG_MODES)):
        p = str(tmp_path / f"dbg{mode}.png")
        img = visualize.render_debug_image(mode, 0, fe, path=p)
        assert os.path.exists(p)
        assert img.shape == (192, 256, 3)
    assert visualize.render_debug_image(1, 2, fe).shape == (48, 64, 3)
    assert "pyr" in fe.keyframe_map[0]
    pk = str(tmp_path / "kf.png")
    visualize.render_keyframe_view(fe, 0, path=pk)
    assert os.path.exists(pk)
    pt = str(tmp_path / "timing.png")
    visualize.render_timing_plot(system.per_mon, path=pt)
    assert os.path.exists(pt)
    assert len(system.per_mon.history) >= 1


def test_watch_artifacts_and_live_retune(tmp_path):
    """test_aux.py::TestWatch on the port: template on startup, atomic
    artifacts, live retuning without restart, pause + quit."""
    from scavislam_tpu_torch.apps.watch import Watcher
    from scavislam_tpu_torch.io.synthetic import SyntheticSequence
    from scavislam_tpu_torch.pipeline.slam_system import SlamSystem

    seq = SyntheticSequence(T_CAM, n_frames=4, step=0.02, device=CPU)
    system = SlamSystem(T_CAM, Config(), threaded=False,
                        enable_loop_closure=False, device=CPU)
    wdir = str(tmp_path / "watch")
    watcher = Watcher(wdir, system, period=0.0)
    tun = os.path.join(wdir, "tunables.cfg")
    template = open(tun).read()
    for key in ("parallax_thr", "pixel_thr", "pause", "quit"):
        assert key in template

    system.process_first_frame(seq.frame(0))
    watcher.tick(0)
    for name in ("map.png", "timing.png", "status.json", "map3d.html"):
        assert os.path.exists(os.path.join(wdir, name)), name
    assert not os.path.exists(os.path.join(wdir, "status.json.tmp"))

    with open(tun, "w") as f:
        f.write("# retuned mid-run\nparallax_thr = 0.011\n"
                "pixel_thr = 33\nfeatureless_thr = 3\ndebug_mode = 2\n")
    assert system.process_frame(seq.frame(1))
    watcher.tick(1)
    assert system.cfg.ui.parallax_thr == pytest.approx(0.011)
    assert system.frontend.cfg.ui.parallax_thr == pytest.approx(0.011)
    fe_cfg = system.cfg.frontend
    assert fe_cfg.new_keyframe_pixel_thr == pytest.approx(33.0)
    assert fe_cfg.new_keyframe_featureless_corners_thr == 3
    assert watcher.debug_mode == 2
    assert os.path.exists(os.path.join(wdir, "debug.png"))
    with open(os.path.join(wdir, "status.json")) as f:
        status = json.load(f)
    assert set(status) == {"frame", "fps", "keyframes", "actkey",
                           "loops_closed", "lost", "relocalizations",
                           "parallax_thr", "debug_mode"}
    assert status["frame"] == 1 and status["keyframes"] >= 1
    assert status["parallax_thr"] == pytest.approx(0.011)
    assert watcher.failures == {}

    with open(tun, "w") as f:
        f.write("pause = 1\nquit = 1\n")
    assert system.process_frame(seq.frame(2))
    watcher.tick(2)
    assert watcher.quit
    system.shutdown()


def test_watch_render_failure_never_stops_the_run(port_system, tmp_path,
                                                  capsys, monkeypatch):
    """A render that raises is reported once on stderr and counted; the
    other artifacts and status.json are still written (watch.py's guard)."""
    from scavislam_tpu_torch.apps.watch import Watcher

    system, _ = port_system

    def broken(*a, **k):
        raise RuntimeError("no map")

    monkeypatch.setattr(visualize, "render_map_topdown", broken)
    watcher = Watcher(str(tmp_path), system, period=0.0)
    watcher.tick(5)
    watcher.tick(6)
    assert watcher.failures == {"map.png": 2}
    assert capsys.readouterr().err.count("map.png failed") == 1
    for name in ("timing.png", "debug.png", "map3d.html", "status.json"):
        assert os.path.exists(tmp_path / name), name


def test_watcher_keeps_existing_tunables(port_system, tmp_path):
    """A tunables.cfg already in the directory is kept, and the running
    system reads it at the first tick (watch.py:85-86)."""
    from scavislam_tpu_torch.apps.watch import Watcher

    system, _ = port_system
    (tmp_path / "tunables.cfg").write_text("debug_mode = 3\n")
    watcher = Watcher(str(tmp_path), system, period=0.0, debug_mode=0)
    assert (tmp_path / "tunables.cfg").read_text() == "debug_mode = 3\n"
    watcher.tick(3)
    assert json.loads((tmp_path / "status.json").read_text())[
        "debug_mode"] == 3


# -- the vocabulary trainer -------------------------------------------------- #

def test_create_dictionary_end_to_end(tmp_path):
    """test_aux.py::TestDictionaryBuilder on the port, the PNGs written by
    utils/png.py."""
    from scavislam_tpu_torch.apps import create_dictionary as cd
    from scavislam_tpu_torch.io.synthetic import SyntheticSequence

    seq = SyntheticSequence(T_CAM, n_frames=3, step=0.1, device=CPU)
    for i in range(3):
        arr = (seq.frame(i)["left"].numpy() * 255).astype(np.uint8)
        write_png(str(tmp_path / f"img_{i}.png"), arr)
    out = str(tmp_path / "dict.npz")
    cd.main([str(tmp_path), "3", "32", "--out", out, "--device", CPU])
    vocab = np.load(out)["vocab"]
    assert vocab.shape == (32, 128)
    np.testing.assert_allclose(np.linalg.norm(vocab, axis=1), 1.0, atol=1e-3)


def test_dictionary_descriptors_and_kmeans_match_twin():
    """descriptors_for_image on one frame equal to the twin's within 1e-4,
    and train_vocabulary from the twin's initial centres (its
    jax.random.choice draw, which no torch generator reproduces) within
    1e-4 of the twin's vocabulary."""
    from scavislam_tpu.apps import create_dictionary as jcd
    from scavislam_tpu.models.placerec import (
        train_vocabulary as j_train,
    )
    from scavislam_tpu_torch.apps import create_dictionary as cd
    from scavislam_tpu_torch.models.placerec import train_vocabulary

    seq = JSeq(J_CAM, n_frames=2, step=0.1)
    descs = []
    for i in range(2):
        img = np.asarray(seq.frame(i)["left"], np.float32)
        dj = jcd.descriptors_for_image(img)
        dt = cd.descriptors_for_image(img, device=CPU)
        assert dt.shape == dj.shape and len(dt) > 100
        np.testing.assert_allclose(dt, dj, atol=1e-4)
        descs.append(dj)
    desc = np.concatenate(descs)
    k, iters = 24, 5
    idx = jax.random.choice(jax.random.PRNGKey(0), len(desc), (k,),
                            replace=len(desc) < k)
    vj = j_train(desc, k=k, iters=iters)
    vt = train_vocabulary(desc, k=k, iters=iters,
                          init_centers=desc[np.asarray(idx)], device=CPU)
    np.testing.assert_allclose(vt, vj, atol=1e-4)


# -- the command lines ------------------------------------------------------ #

def test_stereo_cli_synthetic_run_with_exports(tmp_path):
    """test_aux.py::TestStereoSlamCli on the port: the camera through a
    reference-format .cfg, --viz among the exports."""
    from scavislam_tpu_torch.apps import stereo_slam

    cfg = tmp_path / "test.cfg"
    cfg.write_text(
        "cam.width = 256;\ncam.height = 192;\ncam.f = 195.0;\n"
        "cam.px = 127.0;\ncam.py = 95.0;\ncam.baseline = 0.12;\n")
    out = stereo_slam.main([
        str(cfg), "--synthetic", "6", "--no-loop-closure", "--device", CPU,
        "--out", str(tmp_path / "traj.txt"),
        "--save-map", str(tmp_path / "map.npz"),
        "--save-traj-tum", str(tmp_path / "traj_tum.txt"),
        "--viz", str(tmp_path / "map.png"),
    ])
    assert out["frames_processed"] == 6
    assert out["ate_rmse_m"] < 0.05
    for f in ("traj.txt", "map.npz", "traj_tum.txt", "map.png"):
        assert os.path.exists(tmp_path / f)
    with open(tmp_path / "map.png", "rb") as f:
        assert decode_png(f.read()).shape == (900, 900, 3)


def test_text_font_is_drawn():
    """The 5x7 font: every printable glyph has pixels except the space,
    and a label is drawn with a 6-pixel advance."""
    from scavislam_tpu_torch.utils import raster

    assert raster._FONT[0] == "0" * 14
    assert all(int(g, 16) for g in raster._FONT[1:])
    img = raster.rasterize(raster.blank((40, 10), (0, 0, 0)), [
        raster.Prim("text", ((1, 1),), fill=(255, 255, 255), text="Hi!")])
    cols = np.nonzero(img[..., 0].any(0))[0]
    assert cols.min() == 1 and cols.max() < 1 + 3 * 6

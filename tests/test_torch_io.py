"""The port's disk IO (io/filegrabber, io/rgbd_grabber, apps/dump_sequence)
on the CPU: tests/test_io.py's native-IO, RGB-D-grabber, PNG and live-dump
tests and tests/test_newcollege_ingest.py mirrored against the port, and
parity with the JAX package's grabber on the same files (scan lists,
decoded arrays, grabber frames, the prefetched stack: all exact)."""

import hashlib
import os
import time

import numpy as np
import pytest
import torch

from scavislam_tpu.io import filegrabber as jfg
from scavislam_tpu_torch.apps.dump_sequence import record, record_live
from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.io import filegrabber as tfg
from scavislam_tpu_torch.io.filegrabber import (
    FileGrabber,
    depth_to_disp,
    disparity_from_png_bytes,
    load_image,
    scan_dataset,
)
from scavislam_tpu_torch.io.rgbd_grabber import RgbdGrabber, directory_source
from scavislam_tpu_torch.io.synthetic import SyntheticSequence
from scavislam_tpu_torch.utils.config import load_config
from scavislam_tpu_torch.utils.png import encode_png, write_png

# the 256x192 camera of tests/test_full_system.py and
# tests/test_newcollege_ingest.py
CAM = StereoCamera.create(195.0, (127.0, 95.0), (256, 192), 0.12)
SMALL_CAM = StereoCamera.create(60.0, (31.5, 23.5), (64, 48), 0.12)
N_FRAMES = 10
CPU = "cpu"


def write_pnm(path, img_u8):
    """Binary PGM (P5) for (H, W), PPM (P6) for (H, W, 3)."""
    h, w = img_u8.shape[:2]
    magic = b"P5" if img_u8.ndim == 2 else b"P6"
    with open(path, "wb") as f:
        f.write(magic + b"\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(img_u8).tobytes())


def to_u8(img) -> np.ndarray:
    """A float [0, 1] image (numpy or tensor) -> uint8, rounded."""
    if isinstance(img, torch.Tensor):
        img = img.cpu().numpy()
    return (np.clip(np.asarray(img), 0, 1) * 255 + 0.5).astype(np.uint8)


def write_newcollege_tree(root, frames_u8, width, height, f, pp, baseline):
    """Lay out (left, right) uint8 pairs like the reference's New College
    tree: timestamped `...-rectified-{left,right}.pnm` P5 files split over
    two segment directories, and a reference-format cfg pointing at them.
    Returns the cfg's path."""
    segs = [os.path.join(root, "StereoImages_1225720041_to_1225720118"),
            os.path.join(root, "StereoImages_1225720118_to_1225720193")]
    for s in segs:
        os.makedirs(s, exist_ok=True)
    n = len(frames_u8)
    for i, (left, right) in enumerate(frames_u8):
        seg = segs[i // (n // 2 + 1)]
        stamp = 1225720041.455302 + 0.05 * i
        base = os.path.join(seg, f"StereoImage__{stamp:.6f}-rectified-")
        write_pnm(base + "left.pnm", left)
        write_pnm(base + "right.pnm", right)
    cfg_path = os.path.join(root, "mock_newcollege.cfg")
    with open(cfg_path, "w") as fh:
        fh.write(
            f"cam.width = {width};\ncam.height = {height};\ncam.f = {f};\n"
            f"cam.px = {pp[0]};\ncam.py = {pp[1]};\n"
            f"cam.baseline = {baseline};\n"
            f"framepipe.path_str = {root};\n"
            "framepipe.base_str = .*rectified.*;\n"
            "framepipe.format_str = pnm;\n"
            "framepipe.right_img = 1;\n")
    return cfg_path


@pytest.fixture()
def dataset(tmp_path):
    """A small PNM stereo dataset (tests/test_io.py's)."""
    rng = np.random.RandomState(0)
    for i in range(5):
        for side in ("left", "right"):
            write_pnm(tmp_path / f"img_{i:06d}_{side}.pgm",
                      rng.randint(0, 255, (48, 64), np.uint8))
    return tmp_path


@pytest.fixture()
def newcollege_mock(tmp_path):
    seq = SyntheticSequence(CAM, n_frames=N_FRAMES, step=0.01, device=CPU)
    frames = [seq.frame(i) for i in range(N_FRAMES)]
    cfg_path = write_newcollege_tree(
        str(tmp_path), [(to_u8(f["left"]), to_u8(f["right"])) for f in frames],
        256, 192, 195.0, (127.0, 95.0), 0.12)
    return tmp_path, cfg_path, [f["T_cw_gt"] for f in frames]


def _drain(g):
    frames = list(g)
    g.close()
    return frames


# -- tests/test_io.py TestNativeIO ------------------------------------------

class TestNativeIO:
    def test_scan(self, dataset):
        files = scan_dataset(str(dataset), r"img_.*left.*\.pgm$")
        assert len(files) == 5
        assert files == sorted(files)

    def test_pnm_decode(self, dataset):
        files = scan_dataset(str(dataset), r"img_.*left.*\.pgm$")
        img = load_image(files[0])
        assert img.shape == (48, 64)
        assert img.dtype == np.uint8

    def test_grabber_order_and_pairing(self, dataset):
        g = FileGrabber(str(dataset), base_pattern="img_.*", fmt="pgm",
                        right_img=True)
        assert len(g) == 5
        for i in range(5):
            f = g.next_frame()
            assert f["frame_id"] == i
            assert f["left"].shape == (48, 64)
            assert f["right"].shape == (48, 64)
            assert 0.0 <= f["left"].min() and f["left"].max() <= 1.0
        assert g.next_frame() is None
        g.close()

    def test_grabber_mono_device_prefetch(self, dataset):
        # a mono stream uploads one left uint8 plane (left_dev), no stack
        g = FileGrabber(str(dataset), base_pattern="img_.*", fmt="pgm",
                        right_img=False, device_prefetch=True, device=CPU)
        for i in range(5):
            f = g.next_frame()
            assert "left_dev" in f and "stacked_dev" not in f
            dev = f["left_dev"].numpy()
            assert dev.dtype == np.uint8 and dev.shape == (48, 64)
            np.testing.assert_array_equal(
                dev, (f["left"] * 255.0 + 0.5).astype(np.uint8))
        g.close()

    def test_disparity_reinterpret_roundtrip(self):
        d = np.random.RandomState(1).rand(8, 10).astype(np.float32) * 60
        raw = d.view(np.uint8).reshape(8, 10, 4)
        np.testing.assert_array_equal(disparity_from_png_bytes(raw), d)

    def test_depth_to_disp(self):
        z = np.array([[2.0, 4.0], [0.0, 8.0]], np.float32)
        d = depth_to_disp(z, focal=100.0, baseline=0.5)
        np.testing.assert_allclose(d[0], [25.0, 12.5])
        assert d[1, 0] < 0  # invalid depth -> invalid disparity


# -- tests/test_io.py TestRgbdGrabber, TestNativePng, TestLiveDumpLoop -------

class TestRgbdGrabber:
    def test_latest_value_polling(self):
        frames = iter(range(100))

        def source():
            i = next(frames, None)
            if i is None:
                return None
            return (np.full((4, 4), i, np.uint8),
                    np.full((4, 4), float(i), np.float32))

        g = RgbdGrabber()
        g.start(source, fps=500.0)
        got = []
        t0 = time.time()
        while len(got) < 5 and time.time() - t0 < 5.0:
            f = g.getFrame()
            if f is not None:
                rgb, disp = f
                assert rgb[0, 0] == int(disp[0, 0])
                got.append(int(rgb[0, 0]))
            time.sleep(0.005)
        g.stop()
        assert len(got) == 5
        # the newest frame at each poll: strictly increasing
        assert all(b > a for a, b in zip(got, got[1:]))
        assert RgbdGrabber().getFrame() is None

    def test_directory_replay_source(self, tmp_path):
        seq = SyntheticSequence(CAM, n_frames=3, step=0.01, device=CPU)
        record(iter(seq), str(tmp_path), with_disp=True)
        g = RgbdGrabber()
        g.start(directory_source(str(tmp_path)), fps=200.0)
        f = None
        t0 = time.time()
        while f is None and time.time() - t0 < 5.0:
            f = g.getFrame()
            time.sleep(0.005)
        g.stop()
        assert f is not None
        rgb, disp = f
        assert rgb.shape[:2] == (192, 256)
        assert disp.shape == (192, 256)
        assert np.isfinite(disp).all()


def _png_cases():
    rng = np.random.RandomState(0)
    return {
        "gray": rng.randint(0, 256, (48, 64), np.uint8),
        "rgb": rng.randint(0, 256, (33, 57, 3), np.uint8),
        "rgba": rng.randint(0, 256, (24, 31, 4), np.uint8),
        # smooth gradients: PIL picks the Sub/Up/Average/Paeth filters
        "smooth": np.tile(np.arange(256, dtype=np.uint8), (40, 1)),
    }


class TestNativePng:
    def test_native_png_decode_matches_pil(self, tmp_path):
        from PIL import Image

        for name, arr in _png_cases().items():
            p = str(tmp_path / f"{name}.png")
            Image.fromarray(arr).save(p)
            np.testing.assert_array_equal(load_image(p), arr, err_msg=name)
            np.testing.assert_array_equal(
                load_image(p), np.asarray(Image.open(p)), err_msg=name)


class TestLiveDumpLoop:
    def test_live_capture_record_replay_rerecord(self, tmp_path):
        n = 4
        seq = SyntheticSequence(SMALL_CAM, n_frames=n, step=0.01, device=CPU)
        rendered = []
        state = {"i": 0}

        def camera():
            i = state["i"]
            if i >= n:
                return None
            f = seq.frame(i)
            state["i"] += 1
            left, disp = to_u8(f["left"]), f["disp_gt"].numpy()
            rendered.append((left, disp))
            return left, disp

        dump1 = str(tmp_path / "rec1")
        g = RgbdGrabber()
        g.start(camera, fps=60.0)
        try:
            got = record_live(g, dump1, n, timeout=20.0)
        finally:
            g.stop()
        assert got >= 2  # the latest-value grabber may drop frames

        # replayed through the FileGrabber: the disparity round-trips
        # byte-exactly (float32 reinterpreted as RGBA)
        fg = FileGrabber(dump1, base_pattern="img_.*", fmt="png",
                         right_img=False, disp_img=True)
        f0 = fg.next_frame()
        fg.close()
        replay_u8 = (f0["left"] * 255 + 0.5).astype(np.uint8)
        lefts = {tuple(l.ravel()[:16]): (l, d) for l, d in rendered}
        key = tuple(replay_u8.ravel()[:16])
        assert key in lefts, "replayed frame not among captured frames"
        src_l, src_d = lefts[key]
        np.testing.assert_array_equal(replay_u8, src_l)
        np.testing.assert_array_equal(f0["disp"], src_d)

        # the dump replayed as a live source, re-recorded
        dump2 = str(tmp_path / "rec2")
        g2 = RgbdGrabber()
        g2.start(directory_source(dump1), fps=200.0)
        try:
            got2 = record_live(g2, dump2, got, timeout=20.0)
        finally:
            g2.stop()
        assert got2 >= 1
        fg2 = FileGrabber(dump2, base_pattern="img_.*", fmt="png",
                          right_img=False, disp_img=True)
        r0 = fg2.next_frame()
        fg2.close()
        assert r0["left"].shape == (48, 64)
        assert np.isfinite(r0["disp"]).all()


# -- tests/test_newcollege_ingest.py ---------------------------------------

class TestNewCollegeLayout:
    def test_recursive_scan_order(self, newcollege_mock):
        root, _cfg, _gts = newcollege_mock
        files = scan_dataset(str(root), r".*rectified.*left.*\.pnm$")
        assert len(files) == N_FRAMES
        assert files == sorted(files)  # timestamp order == frame order
        assert all(f.endswith("-rectified-left.pnm") for f in files)
        assert len({os.path.dirname(f) for f in files}) == 2

    def test_grabber_pairs_reference_names(self, newcollege_mock):
        _root, cfg_path, _gts = newcollege_mock
        cfg = load_config(str(cfg_path))
        assert cfg.framepipe.base_str == ".*rectified.*"
        g = FileGrabber(cfg.framepipe.path_str,
                        base_pattern=cfg.framepipe.base_str,
                        fmt=cfg.framepipe.format_str,
                        right_img=cfg.framepipe.right_img)
        assert len(g) == N_FRAMES
        for i in range(N_FRAMES):
            f = g.next_frame()
            assert f["frame_id"] == i
            assert f["left"].shape == (192, 256)
            assert f["right"].shape == (192, 256)
        g.close()

    def test_full_system_runs_reference_layout(self, newcollege_mock):
        """reference cfg -> native grabber -> SlamSystem -> trajectory."""
        import dataclasses

        from scavislam_tpu_torch.pipeline.slam_system import (
            SlamSystem,
            ate_rmse,
        )

        _root, cfg_path, gts = newcollege_mock
        cfg = load_config(str(cfg_path))
        cfg = dataclasses.replace(
            cfg, ui=dataclasses.replace(cfg.ui, parallax_thr=0.25),
            graph=dataclasses.replace(cfg.graph, inner_window=5,
                                      outer_window=20))
        cam = StereoCamera.create(
            cfg.cam.f, (cfg.cam.px, cfg.cam.py),
            (cfg.cam.width, cfg.cam.height), cfg.cam.baseline)
        g = FileGrabber(cfg.framepipe.path_str,
                        base_pattern=cfg.framepipe.base_str,
                        fmt=cfg.framepipe.format_str,
                        right_img=cfg.framepipe.right_img)
        frames = _drain(g)
        system = SlamSystem(cam, cfg, threaded=False,
                            enable_loop_closure=False, device=CPU)
        system.process_first_frame(frames[0])
        for f in frames[1:]:
            assert system.process_frame(f)
        system.finish()
        system.shutdown()
        assert system.export_trajectory().shape[0] == N_FRAMES
        ate = ate_rmse(system.trajectory, gts)
        assert np.isfinite(ate) and ate < 0.05, ate

    def test_float_disparity_reinterpret(self, tmp_path):
        """`<base>left.png` + `<base>disp.png`, the disparity PNG's four
        channels the raw float32 bytes."""
        rng = np.random.RandomState(3)
        img = rng.randint(0, 255, (48, 64), np.uint8)
        disp = rng.rand(48, 64).astype(np.float32) * 30.0
        write_png(str(tmp_path / "x-rgbd-left.png"), img)
        write_png(str(tmp_path / "x-rgbd-disp.png"),
                  disp.view(np.uint8).reshape(48, 64, 4))
        g = FileGrabber(str(tmp_path), base_pattern=".*rgbd.*", fmt="png",
                        right_img=False, disp_img=True)
        f = g.next_frame()
        g.close()
        np.testing.assert_array_equal(f["disp"], disp)


# -- parity with the JAX package's grabber on the same files ----------------

def test_scan_matches_jax(dataset, newcollege_mock):
    root = str(newcollege_mock[0])
    for path, pat in ((str(dataset), r"img_.*left.*\.pgm$"),
                      (root, r".*rectified.*left.*\.pnm$"),
                      (root, r".*right.*")):
        assert scan_dataset(path, pat) == jfg.scan_dataset(path, pat)


@pytest.mark.parametrize("kind", ["p5", "p6", "gray_png", "rgb_png",
                                  "rgba_png"])
def test_load_image_matches_jax(tmp_path, kind):
    from PIL import Image

    rng = np.random.RandomState(7)
    shape = {"p5": (37, 53), "p6": (37, 53, 3), "gray_png": (41, 29),
             "rgb_png": (41, 29, 3), "rgba_png": (41, 29, 4)}[kind]
    arr = rng.randint(0, 256, shape, np.uint8)
    if kind.startswith("p"):
        p = str(tmp_path / f"x.{'pgm' if kind == 'p5' else 'ppm'}")
        write_pnm(p, arr)
    else:
        p = str(tmp_path / "x.png")
        Image.fromarray(arr).save(p)
    got = load_image(p)
    np.testing.assert_array_equal(got, jfg.load_image(p))
    np.testing.assert_array_equal(got, arr)
    assert got.dtype == np.uint8
    # one-pass decode with a size hint, large or too small
    np.testing.assert_array_equal(load_image(p, arr.size), arr)
    np.testing.assert_array_equal(load_image(p, 7), arr)


def _rgbd_dump(tmp_path, color=False):
    """Three frames with left, right, disparity and depth PNGs (RGB images
    when `color`), written with the port's PNG writer."""
    rng = np.random.RandomState(11)
    for i in range(3):
        shape = (24, 32, 3) if color else (24, 32)
        for side in ("left", "right"):
            write_png(str(tmp_path / f"img_{i:06d}_{side}.png"),
                      rng.randint(0, 256, shape, np.uint8))
        disp = (rng.rand(24, 32) * 20).astype(np.float32)
        depth = (rng.rand(24, 32) * 5).astype(np.float32)
        depth[0, :4] = 0.0  # invalid depth -> disparity -1
        for kind, v in (("disp", disp), ("depth", depth)):
            write_png(str(tmp_path / f"img_{i:06d}_{kind}.png"),
                      v.view(np.uint8).reshape(24, 32, 4))
    return tmp_path


@pytest.mark.parametrize("mode", ["stereo", "disp_img", "depth_img"])
def test_grabber_frames_match_jax(tmp_path, mode):
    root = str(_rgbd_dump(tmp_path))
    kw = dict(base_pattern="img_.*", fmt="png", right_img=True,
              disp_img=mode == "disp_img", depth_img=mode == "depth_img",
              focal=30.0, baseline=0.1)
    got = _drain(FileGrabber(root, **kw))
    want = _drain(jfg.FileGrabber(root, **kw))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in b:
            assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("color", [False, True], ids=["gray", "rgb"])
def test_prefetched_stack_matches_jax(tmp_path, color):
    # the CPU stack is what the twin uploads: its _as_u8_gray planes, and
    # the float (3, H, W) stack with an external disparity plane
    root = str(_rgbd_dump(tmp_path, color))
    files = jfg.scan_dataset(root, r"img_.*left.*\.png$")
    for disp_img in (False, True):
        frames = _drain(FileGrabber(root, base_pattern="img_.*", fmt="png",
                                    disp_img=disp_img, device_prefetch=True,
                                    device=CPU))
        for lp, f in zip(files, frames):
            left = jfg.load_image(lp)
            right = jfg.load_image(lp.replace("left", "right"))
            if disp_img:
                raw = jfg.load_image(lp.replace("left", "disp"))
                want = np.stack([jfg.to_gray_f32(left), jfg.to_gray_f32(right),
                                 jfg.disparity_from_png_bytes(raw)])
            else:
                want = np.stack([jfg._as_u8_gray(left),
                                 jfg._as_u8_gray(right)])
            got = f["stacked_dev"]
            assert got.device.type == "cpu" and f["upload_event"] is None
            assert got.numpy().dtype == want.dtype
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["gray", "rgb", "rgba", "smooth"])
def test_png_writer_decodes_exactly(tmp_path, name):
    from PIL import Image

    arr = _png_cases()[name]
    p = str(tmp_path / f"{name}.png")
    write_png(p, arr)
    np.testing.assert_array_equal(load_image(p), arr)
    np.testing.assert_array_equal(jfg.load_image(p), arr)
    np.testing.assert_array_equal(np.asarray(Image.open(p)), arr)
    with pytest.raises(ValueError):
        encode_png(arr.astype(np.float32))


def test_native_library_built_from_source(tmp_path, monkeypatch):
    # the port's library lives under build/kernels/, keyed by the source's
    # hash; a build into a fresh directory leaves the tracked binary alone
    tracked = tfg._REPO / "build" / "libsvtgrabber.so"
    before = hashlib.sha256(tracked.read_bytes()).hexdigest()
    loaded = tfg._native()._name
    assert os.path.dirname(loaded) == str(tfg.BUILD_DIR)
    assert os.path.basename(loaded).startswith("libsvtgrabber_")
    monkeypatch.setattr(tfg, "BUILD_DIR", tmp_path / "kernels")
    built = tfg._build()
    assert built.parent == tmp_path / "kernels"
    assert built.name == os.path.basename(loaded)
    assert sorted(p.name for p in built.parent.iterdir()) == [built.name]
    assert hashlib.sha256(tracked.read_bytes()).hexdigest() == before


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "grabber.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tfg, "SOURCE", bad)
    monkeypatch.setattr(tfg, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="grabber.cpp"):
        tfg._build()
    assert list((tmp_path / "kernels").iterdir()) == []

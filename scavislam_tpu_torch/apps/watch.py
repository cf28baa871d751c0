"""Live observability for headless runs: the Pangolin-GUI analogue (port
of scavislam_tpu.apps.watch).

The reference's stereo_slam GUI (stereo_slam.cpp:124-642) lets you WATCH a
run (3-D map view, per-frame debug views, timing plot) and RETUNE it live
through ~12 pangolin::Var widgets (stereo_slam.cpp:234-257: ui.parallax_thr,
ui.show_* toggles, frontend thresholds...). A machine with a card usually
has no display, so this module provides the same two capabilities over the
filesystem:

- **watching**: the PNG composites of apps/visualize.py (top-down map +
  trajectory, per-frame debug view, stacked timing histogram), written by
  utils/png.py, are re-rendered ATOMICALLY
  (tmp + rename, so a viewer never sees a torn file) into the watch
  directory at a configurable period, alongside a ``status.json`` with live
  counters and ``map3d.html`` — the INTERACTIVE 3-D map/graph view
  (apps/map3d.py; orbit/pan/zoom, camera pose survives refresh). Point any
  auto-reloading image viewer / browser tab at the directory.
- **retuning**: ``tunables.cfg`` in the watch directory is re-read every
  refresh; edits apply to the RUNNING system without restart. A commented
  template is written on startup. Live-tunable (value-read-per-frame)
  settings only — anything that sizes device buffers (resolution,
  capacities, stereo method) is intentionally absent.

Supported tunables (reference Var in parens):
  parallax_thr        keyframe translation threshold (ui.parallax_thr)
  pixel_thr           keyframe mean-track-length threshold
                      (frontend.new_keyframe_pixel_thr)
  featureless_thr     featureless-quadrant count threshold
                      (frontend.new_keyframe_featureless_corners_thr)
  min_num_points      per-quadrant featureless cutoff (ui.min_num_points)
  debug_mode          which debug composite to render, -1 = off
                      (ui.show_debug modes 0-6)
  debug_level         pyramid level for the debug view (ui.debug_level)
  period              refresh period in seconds
  pause               1 = hold the frame loop (re-read until 0)
  quit                1 = stop the run cleanly
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

from scavislam_tpu_torch.utils.png import write_png_atomic

TEMPLATE = """\
# scavislam_tpu live tunables — edits apply to the RUNNING system at the
# next refresh (see watch.py for the list; '#' comments and blank lines ok)
parallax_thr = {parallax_thr}
pixel_thr = {pixel_thr}
featureless_thr = {featureless_thr}
min_num_points = {min_num_points}
debug_mode = {debug_mode}
debug_level = 0
period = {period}
pause = 0
quit = 0
"""

_FLOAT_KEYS = {"parallax_thr", "pixel_thr", "period"}
_INT_KEYS = {"featureless_thr", "min_num_points", "debug_mode",
             "debug_level", "pause", "quit"}


def _atomic_save(img, path):
    write_png_atomic(path, img)


class Watcher:
    def __init__(self, dirpath: str, system, period: float = 1.0,
                 num_disp: int = 64, debug_mode: int = 0):
        self.dir = dirpath
        self.system = system
        self.period = float(period)
        self.num_disp = num_disp
        self.debug_mode = int(debug_mode)
        self.debug_level = 0
        self.quit = False
        self._last = 0.0
        self._last_n = 0
        self._last_t = time.monotonic()
        self._fps = 0.0
        # renders that raised, by artifact name: count (reported once each)
        self.failures = {}
        os.makedirs(dirpath, exist_ok=True)
        self._tunables_path = os.path.join(dirpath, "tunables.cfg")
        if not os.path.exists(self._tunables_path):
            cfg = system.cfg
            with open(self._tunables_path, "w") as f:
                f.write(TEMPLATE.format(
                    parallax_thr=cfg.ui.parallax_thr,
                    pixel_thr=cfg.frontend.new_keyframe_pixel_thr,
                    featureless_thr=(
                        cfg.frontend.new_keyframe_featureless_corners_thr),
                    min_num_points=cfg.ui.min_num_points,
                    debug_mode=self.debug_mode,
                    period=self.period,
                ))

    # -- tunables ---------------------------------------------------------- #
    def _read_tunables(self) -> dict:
        vals = {}
        try:
            with open(self._tunables_path) as f:
                for line in f:
                    line = line.split("#", 1)[0].strip()
                    if "=" not in line:
                        continue
                    k, v = (s.strip() for s in line.split("=", 1))
                    try:
                        if k in _FLOAT_KEYS:
                            vals[k] = float(v)
                        elif k in _INT_KEYS:
                            vals[k] = int(float(v))
                    except ValueError:
                        pass
        except OSError:
            pass
        return vals

    def _apply_tunables(self, vals: dict):
        sysm = self.system
        cfg = sysm.cfg
        ui, fe = cfg.ui, cfg.frontend
        new_ui = dataclasses.replace(
            ui,
            parallax_thr=vals.get("parallax_thr", ui.parallax_thr),
            min_num_points=vals.get("min_num_points", ui.min_num_points),
        )
        new_fe = dataclasses.replace(
            fe,
            new_keyframe_pixel_thr=vals.get(
                "pixel_thr", fe.new_keyframe_pixel_thr),
            new_keyframe_featureless_corners_thr=vals.get(
                "featureless_thr",
                fe.new_keyframe_featureless_corners_thr),
        )
        if new_ui != ui or new_fe != fe:
            new_cfg = dataclasses.replace(cfg, ui=new_ui, frontend=new_fe)
            sysm.cfg = new_cfg
            # the frontend reads these thresholds per frame
            sysm.frontend.cfg = new_cfg
        self.debug_mode = vals.get("debug_mode", self.debug_mode)
        self.debug_level = vals.get("debug_level", self.debug_level)
        self.period = vals.get("period", self.period)
        self.quit = bool(vals.get("quit", 0))
        return bool(vals.get("pause", 0))

    # -- refresh ----------------------------------------------------------- #
    def tick(self, n: int, gt_poses=None):
        """Call once per frame; renders + re-reads tunables at most every
        `period` seconds. Blocks while paused. Sets self.quit on request."""
        now = time.monotonic()
        if now - self._last < self.period and not self.quit:
            return
        self._last = now
        dt = now - self._last_t
        if dt > 0:
            self._fps = (n - self._last_n) / dt
        self._last_n, self._last_t = n, now

        paused = self._apply_tunables(self._read_tunables())
        self._render(n, gt_poses)
        while paused and not self.quit:
            time.sleep(0.2)
            paused = self._apply_tunables(self._read_tunables())

    def _guarded(self, what: str, fn):
        """Run one render; a failure is reported once per kind on stderr
        and never stops the run."""
        try:
            fn()
        except Exception as e:
            if what not in self.failures:
                print(f"watch: {what} failed: {type(e).__name__}: {e}",
                      file=sys.stderr)
            self.failures[what] = self.failures.get(what, 0) + 1

    def _render(self, n: int, gt_poses=None):
        from scavislam_tpu_torch.apps.map3d import export_map_html
        from scavislam_tpu_torch.apps.visualize import (
            render_debug_image,
            render_map_topdown,
            render_timing_plot,
        )

        sysm = self.system
        gt = gt_poses or None
        self._guarded("map.png", lambda: _atomic_save(
            render_map_topdown(sysm.backend.graph, trajectory=sysm.trajectory,
                               gt_poses=gt),
            os.path.join(self.dir, "map.png")))
        # interactive 3-D view; localStorage keeps the browser camera across
        # these re-exports, so refreshing is seamless
        self._guarded("map3d.html", lambda: export_map_html(
            sysm.backend.graph, trajectory=sysm.trajectory, gt_poses=gt,
            path=os.path.join(self.dir, "map3d.html"),
            actkey_id=sysm.frontend.actkey_id))
        if self.debug_mode >= 0 and sysm.frontend.keyframe_map:
            self._guarded("debug.png", lambda: _atomic_save(
                render_debug_image(self.debug_mode, self.debug_level,
                                   sysm.frontend, num_disp=self.num_disp),
                os.path.join(self.dir, "debug.png")))
        self._guarded("timing.png", lambda: _atomic_save(
            render_timing_plot(sysm.per_mon),
            os.path.join(self.dir, "timing.png")))
        status = {
            "frame": n,
            "fps": round(self._fps, 1),
            "keyframes": len(sysm.frontend.keyframe_map),
            "actkey": sysm.frontend.actkey_id,
            "loops_closed": len(sysm.closed_loops),
            "lost": sysm.lost,
            "relocalizations": sysm.relocalizations,
            "parallax_thr": sysm.cfg.ui.parallax_thr,
            "debug_mode": self.debug_mode,
        }
        tmp = os.path.join(self.dir, "status.json.tmp")
        with open(tmp, "w") as f:
            json.dump(status, f, indent=1)
        os.replace(tmp, os.path.join(self.dir, "status.json"))

"""Interactive simulation UI — the WPF MainWindow as a tiny HTTP app.

Port of ``slamnet_tpu/io/interactive.py``.  The reference's Simulation
window lets the user drag the robot around the field with the mouse while
both SLAM pipelines track it live (MainWindow.xaml.cs):

- left mouse drag   -> teleport the lidar to the cursor  (:448-453)
- right mouse drag  -> point the heading at the cursor   (:459-465)
- mouse wheel       -> zoom the field view               (:471-479)
- Reset button      -> reset processors + start pose     (:485-489, :143-151)
- background Scan() thread at lidar rate with a first-divergence
  debug dump                                             (:136-199)

Here a stdlib ThreadingHTTPServer serves one HTML page; the browser posts
pose/heading/reset commands; a background thread steps Hector (and
CoreSLAM) at the lidar rate on the session's device (the card unless the
caller names another): each step ray-traces a revolution on the device with
noise from a ``torch.Generator`` there, runs ``hector.update`` at
``HectorConfig()`` (4 levels, ``gather`` + line updates: K3 + K4) and
``coreslam.update_cloud`` at ``CoreSlamConfig()`` (Monte-Carlo), then reads
the match pose back for the divergence oracle.  The page polls JSON state
(map PNG + poses + rates) ~10x/s.  ``hector.update`` writes the maps in
place, so ``step`` replaces the states under the session's lock and
``frame`` copies them under it: the HTTP thread never reads a state that a
step is half way through.

Run: ``python -c "from slamnet_tpu_torch.io import interactive as i;
i.serve(i.InteractiveSession()); input()"``, then open http://127.0.0.1:8801
"""
from __future__ import annotations

import html
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from ..core.config import CoreSlamConfig, HectorConfig, SimConfig
from ..models import coreslam, hector
from ..sim import default_field, lidar, office_field
from . import export
from .live import _png_b64


class InteractiveSession:
    """Owns simulator + SLAM state and steps them; thread-safe snapshots.

    The reference's Scan() loop (MainWindow.xaml.cs:136-199): snapshot the
    (mouse-driven) real pose, ray-trace a revolution, update CoreSLAM and
    Hector with the cloud (the first 10 loops map without matching), check
    for the first divergence.  ``hcfg`` / ``ccfg`` replace the defaults
    (``HectorConfig()``, ``CoreSlamConfig()``).
    """

    def __init__(self, device: torch.device | str = "cuda",
                 run_coreslam: bool = True, seed: int = 0,
                 world: str = "default", hcfg: HectorConfig | None = None,
                 ccfg: CoreSlamConfig | None = None):
        self.device = torch.device(device)
        self.sim = SimConfig()
        self.hcfg = hcfg if hcfg is not None else HectorConfig()
        self.ccfg = ((ccfg if ccfg is not None else CoreSlamConfig())
                     if run_coreslam else None)
        if world == "office":
            # the multi-room loop-closure world (sim/field.py)
            self.field = office_field(device=self.device)
        else:
            self.field = default_field(self.sim.field_scale,
                                       self.sim.field_offset,
                                       device=self.device)
        self.angles = torch.as_tensor(
            lidar.revolution_angles(self.sim.num_scan_points),
            device=self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._lock = threading.Lock()
        self.real_pose = np.asarray(self.sim.start_pose, np.float32)
        self.loops = 0
        self.diverged_at: Optional[int] = None
        self.scan_rate_ema = 0.0
        self._do_reset = False
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._init_states()

    def _init_states(self) -> None:
        start = torch.tensor(self.sim.start_pose, dtype=torch.float32,
                             device=self.device)
        hstate = hector.init(self.hcfg, start, self.device)
        cstate = (coreslam.init(self.ccfg, start, seed=1, device=self.device)
                  if self.ccfg is not None else None)
        with self._lock:
            self.hstate, self.cstate = hstate, cstate

    def _cloud(self, real_pose: torch.Tensor):
        sim = self.sim
        radii, valid = lidar.scan_revolution(
            self.field, real_pose, self.angles, sim.max_scan_dist,
            sim.measure_error, self._gen)
        return lidar.make_cloud(self.angles, radii, valid)

    # ---- mouse commands (MainWindow.xaml.cs:448-465) ----

    def set_position(self, x: float, y: float) -> None:
        """Left drag: teleport the lidar, keep heading (UpdateLidarPosition)."""
        with self._lock:
            self.real_pose = np.asarray(
                [x, y, self.real_pose[2]], np.float32)

    def set_heading_toward(self, x: float, y: float) -> None:
        """Right drag: heading = atan2(cursor - lidar) (UpdateLidarViewDirection)."""
        with self._lock:
            ang = math.atan2(y - float(self.real_pose[1]),
                             x - float(self.real_pose[0]))
            self.real_pose = np.asarray(
                [self.real_pose[0], self.real_pose[1], ang], np.float32)

    def reset(self) -> None:
        """Reset button: flag consumed at the top of the scan loop (:143-151)."""
        self._do_reset = True

    # ---- the scan loop ----

    def step(self) -> None:
        """One Scan() iteration; safe to call directly (tests) or from run()."""
        if self._do_reset:
            self._init_states()
            with self._lock:
                self.real_pose = np.asarray(self.sim.start_pose, np.float32)
            self.loops = 0
            self.diverged_at = None
            self._do_reset = False
        with self._lock:
            snap = self.real_pose.copy()
        t0 = time.perf_counter()
        pose = torch.as_tensor(snap, device=self.device)
        cloud = self._cloud(pose)
        ccloud = self._cloud(pose) if self.cstate is not None else None
        with self._lock:
            self.hstate, _ = hector.update(self.hstate, cloud,
                                           self.hstate.match_pose, self.hcfg,
                                           self.loops < 10)
            if ccloud is not None:
                self.cstate, _ = coreslam.update_cloud(
                    self.cstate, ccloud, self.cstate.pose, self.ccfg)
            est_t = self.hstate.match_pose
        est = est_t.cpu().numpy()          # waits for the step
        dt = time.perf_counter() - t0
        self.scan_rate_ema = (0.9 * self.scan_rate_ema + 0.1 / max(dt, 1e-6)
                              if self.scan_rate_ema else 1.0 / max(dt, 1e-6))
        self.loops += 1
        # first-divergence oracle (MainWindow.xaml.cs:182-196)
        if self.diverged_at is None:
            lin = float(np.hypot(*(est[:2] - snap[:2])))
            ang = abs(math.degrees((est[2] - snap[2] + math.pi)
                                   % (2 * math.pi) - math.pi))
            if lin > 1.0 or ang > 10.0:
                self.diverged_at = self.loops

    def run(self, max_rate: Optional[float] = None) -> None:
        """Background scan thread (lidarThread, MainWindow.xaml.cs:103)."""
        rate = max_rate or self.sim.scans_per_second
        self._running = True

        def loop():
            while self._running:
                t0 = time.time()
                self.step()
                sleep = 1.0 / rate - (time.time() - t0)
                if sleep > 0:
                    time.sleep(sleep)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    # ---- state for the browser ----

    def frame(self, level: int = 0) -> dict:
        """JSON-ready snapshot: map PNG (b64) + poses + stats.

        ``level`` selects a Hector pyramid level; level == -1 renders the
        CoreSLAM hole map instead (the reference's SLAM-selector combo box,
        MainWindow.xaml:20-27 / Draw() hole-map branch :227-249)."""
        level = int(level)
        hole = level < 0 and self.cstate is not None
        if not hole:
            level = max(0, min(self.hcfg.num_levels - 1, level))
        with self._lock:        # copies on the device, in stream order
            grid = (self.cstate.hole_map.clone() if hole else
                    hector.level_view(self.hstate.maps, self.hcfg,
                                      level).clone())
            hpose = self.hstate.match_pose.clone()
            cpose = (self.cstate.pose.clone() if self.cstate is not None
                     else None)
            real = [float(v) for v in self.real_pose]
            scan, rate, diverged = self.loops, self.scan_rate_ema, \
                self.diverged_at
        if hole:
            size = self.ccfg.hole_map_size
            bmp = (export.hole_map_u16(grid, size)
                   >> 8).astype(np.uint8)   # Gray16 -> 8-bit for the PNG
            level, res = -1, self.ccfg.physical_map_size / size
        else:
            size = self.hcfg.level_sizes[level]
            bmp = export.occupancy_bitmap(grid.reshape(-1), size)
            res = float(self.hcfg.level_resolutions[level])
        out = {
            "png": _png_b64(np.flipud(bmp.reshape(size, size))),
            "level": level,
            "size": size,
            "res": res,
            "real": real,
            "hector": [float(v) for v in hpose.cpu()],
            "scan": int(scan),
            "rate": round(rate, 1),
            "diverged_at": diverged,
            "levels": list(self.hcfg.level_sizes),
            "has_coreslam": cpose is not None,
        }
        if cpose is not None:
            out["coreslam"] = [float(v) for v in cpose.cpu()]
        return out


class _Handler(BaseHTTPRequestHandler):
    session: InteractiveSession  # set by serve()

    def log_message(self, *a):  # silence per-request stderr spam
        pass

    def _json(self, obj, code=200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path.startswith("/state"):
            level = 0
            if "level=" in self.path:
                try:
                    level = int(self.path.split("level=")[1].split("&")[0])
                except ValueError:
                    pass
            self._json(self.session.frame(level))
        else:
            body = _PAGE.replace("__TITLE__", html.escape(
                "slamnet_tpu_torch interactive simulation")).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        data = json.loads(self.rfile.read(n) or b"{}")
        if self.path == "/pose":
            self.session.set_position(float(data["x"]), float(data["y"]))
        elif self.path == "/heading":
            self.session.set_heading_toward(float(data["x"]), float(data["y"]))
        elif self.path == "/reset":
            self.session.reset()
        self._json({"ok": True})


def serve(session: InteractiveSession, port: int = 8801,
          host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Start the scan thread and an HTTP server on ``host``:``port`` (0 picks
    a free port: ``server.server_address``); returns the running server.
    Stop with ``session.stop()``, ``server.shutdown()`` and
    ``server.server_close()``."""
    handler = type("Handler", (_Handler,), {"session": session})
    session.run()
    srv = ThreadingHTTPServer((host, port), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body { font-family: sans-serif; background: #111; color: #ddd; margin: 1em; }
 #wrap { max-width: 860px; margin: auto; }
 canvas { border: 1px solid #444; image-rendering: pixelated; width: 800px;
          cursor: crosshair; }
 .bar { margin: .5em 0; display: flex; gap: 1em; align-items: center; }
 button { background: #333; color: #ddd; border: 1px solid #555; padding: .3em 1em; }
 .legend span { margin-right: 1.2em; }
</style></head><body><div id="wrap">
<h3>__TITLE__</h3>
<div class="bar">
  <button id="reset">reset</button>
  <label>level <select id="level"></select></label>
  <span id="info"></span>
</div>
<canvas id="cv" width="800" height="800"></canvas>
<div class="legend"><span style="color:#f55">&#9632; real (drag: left=move,
right=aim)</span><span style="color:#5f5">&#9632; hector</span>
<span style="color:#59f">&#9632; coreslam</span>
<span>wheel: zoom</span></div>
<script>
const cv = document.getElementById('cv');
const ctx = cv.getContext('2d');
const info = document.getElementById('info');
const levelSel = document.getElementById('level');
let state = null, zoom = 1, img = new Image();
function worldOf(e) {
  // canvas pixel -> world meters (origin lower-left), undoing CSS zoom
  const r = cv.getBoundingClientRect();
  const px = (e.clientX - r.left) / r.width * cv.width;
  const py = (e.clientY - r.top) / r.height * cv.height;
  const span = state.size * state.res;
  return {x: px / cv.width * span, y: (1 - py / cv.height) * span};
}
cv.oncontextmenu = e => e.preventDefault();
function post(path, body) {
  fetch(path, {method: 'POST', body: JSON.stringify(body || {})});
}
function drive(e) {
  if (!state) return;
  if (e.buttons & 1) post('/pose', worldOf(e));
  if (e.buttons & 2) post('/heading', worldOf(e));
}
cv.onmousedown = drive;
cv.onmousemove = drive;
cv.onwheel = e => {
  e.preventDefault();
  zoom = Math.max(1, Math.min(8, zoom + Math.sign(e.deltaY) * -0.5));
  cv.style.width = (800 * zoom) + 'px';
};
document.getElementById('reset').onclick = () => post('/reset');
function mark(pose, color) {
  const span = state.size * state.res;
  const x = pose[0] / span * cv.width;
  const y = cv.height - pose[1] / span * cv.height;
  ctx.strokeStyle = color; ctx.lineWidth = 2;
  ctx.beginPath(); ctx.arc(x, y, 6, 0, 2 * Math.PI); ctx.stroke();
  ctx.beginPath(); ctx.moveTo(x, y);
  ctx.lineTo(x + 14 * Math.cos(pose[2]), y - 14 * Math.sin(pose[2]));
  ctx.stroke();
}
function draw() {
  if (!state) return;
  ctx.imageSmoothingEnabled = false;
  ctx.drawImage(img, 0, 0, cv.width, cv.height);
  mark(state.real, '#f55');
  mark(state.hector, '#5f5');
  if (state.coreslam) mark(state.coreslam, '#59f');
  const err = Math.hypot(state.hector[0] - state.real[0],
                         state.hector[1] - state.real[1]);
  info.textContent = `scan ${state.scan}  ${state.rate} scans/s  ` +
    `hector err ${err.toFixed(3)} m` +
    (state.diverged_at ? `  DIVERGED@${state.diverged_at}` : '');
}
async function poll() {
  try {
    const r = await fetch('/state?level=' + (levelSel.value || 0));
    state = await r.json();
    if (!levelSel.options.length) {
      state.levels.forEach((s, i) => {
        const o = document.createElement('option');
        o.value = i; o.textContent = `hector ${i} (${s}px)`;
        levelSel.appendChild(o);
      });
      if (state.has_coreslam) {
        const o = document.createElement('option');
        o.value = -1; o.textContent = 'coreslam hole map';
        levelSel.appendChild(o);
      }
    }
    img.onload = draw;
    img.src = 'data:image/png;base64,' + state.png;
  } catch (e) {}
  setTimeout(poll, 120);
}
poll();
</script></div></body></html>
"""

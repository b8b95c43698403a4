"""Live replay viewer — the WPF Simulation window as a self-contained HTML file.

Port of ``slamnet_tpu/io/live.py``: the recorder and the PNG encoder are
numpy and the standard library; maps and poses may be tensors on any device
(each copied to the host once).

The reference's interactive UI (MainWindow.xaml.cs:215-275: 50 fps map redraw,
layer selector, pose overlays) replaced by a headless-friendly equivalent: a
recorder collects per-scan frames (every pyramid level as a grayscale PNG +
poses) and writes ONE self-contained HTML file with a scan slider, play/pause,
pyramid-level selector, and real/estimated pose overlays — open it in any
browser, no server or dependencies.
"""
from __future__ import annotations

import base64
import html
import json
from typing import List

import numpy as np

from . import export
from .export import host


def _png_bytes(gray: np.ndarray) -> bytes:
    """Encode a [H, W] uint8 grayscale image as a PNG.

    Hand-rolled (zlib + struct): the interactive UI encodes a frame per poll
    at ~10 Hz, and a matplotlib round-trip per frame was the serving path's
    only heavyweight dependency (VERDICT r03 weak #8)."""
    import struct
    import zlib

    gray = np.ascontiguousarray(gray, np.uint8)
    h, w = gray.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)  # 8-bit grayscale
    # one filter byte (0 = None) per scanline
    raw = b"".join(b"\x00" + gray[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def _png_b64(gray: np.ndarray) -> str:
    """Encode a [H, W] uint8 grayscale image as base64 PNG."""
    return base64.b64encode(_png_bytes(np.asarray(gray))).decode("ascii")


class ReplayRecorder:
    """Collects Hector frames and writes the HTML replay.

    cfg: HectorConfig; every: record every N-th scan (keeps files small).
    """

    def __init__(self, cfg, every: int = 4):
        self.cfg = cfg
        self.every = every
        self.frames: List[dict] = []
        self._count = 0

    def add(self, scan_index: int, maps_flat, match_pose,
            truth_pose=None) -> None:
        if self._count % self.every:
            self._count += 1
            return
        self._count += 1
        levels = []
        maps = host(maps_flat)
        for level in range(self.cfg.num_levels):
            s = self.cfg.level_sizes[level]
            off = self.cfg.level_offsets[level]
            bmp = export.occupancy_bitmap(maps[off:off + s * s], s)
            # flip vertically so canvas row 0 = world y max (origin lower-left)
            levels.append(_png_b64(np.flipud(np.asarray(bmp).reshape(s, s))))
        self.frames.append({
            "scan": int(scan_index),
            "levels": levels,
            "est": [float(v) for v in host(match_pose)],
            "truth": ([float(v) for v in host(truth_pose)]
                      if truth_pose is not None else None),
        })

    def write(self, path: str, title: str = "slamnet_tpu_torch replay") -> None:
        cfg = self.cfg
        meta = {
            "level_sizes": list(cfg.level_sizes),
            "level_res": list(cfg.level_resolutions),
            "frames": self.frames,
        }
        doc = _HTML_TEMPLATE.replace("__TITLE__", html.escape(title)) \
                            .replace("__DATA__", json.dumps(meta))
        with open(path, "w") as f:
            f.write(doc)


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body { font-family: sans-serif; background: #111; color: #ddd; margin: 1em; }
 #wrap { max-width: 860px; margin: auto; }
 canvas { border: 1px solid #444; image-rendering: pixelated; width: 800px; }
 .bar { margin: .5em 0; display: flex; gap: 1em; align-items: center; }
 input[type=range] { flex: 1; }
 button { background: #333; color: #ddd; border: 1px solid #555; padding: .3em 1em; }
 .legend span { margin-right: 1.2em; }
</style></head><body><div id="wrap">
<h3>__TITLE__</h3>
<div class="bar">
  <button id="play">&#9654; play</button>
  <label>level <select id="level"></select></label>
  <span id="info"></span>
</div>
<div class="bar"><input type="range" id="slider" min="0" value="0"></div>
<canvas id="cv" width="800" height="800"></canvas>
<div class="legend"><span style="color:#f55">&#9632; truth</span>
<span style="color:#5f5">&#9632; estimate</span></div>
<script>
const data = __DATA__;
const frames = data.frames;
const slider = document.getElementById('slider');
const levelSel = document.getElementById('level');
const info = document.getElementById('info');
const cv = document.getElementById('cv');
const ctx = cv.getContext('2d');
slider.max = frames.length - 1;
data.level_sizes.forEach((s, i) => {
  const o = document.createElement('option');
  o.value = i; o.textContent = `${i} (${s}px, ${data.level_res[i]} m/px)`;
  levelSel.appendChild(o);
});
const imgs = frames.map(f => f.levels.map(b64 => {
  const im = new Image(); im.src = 'data:image/png;base64,' + b64; return im;
}));
function mark(pose, color, size, res) {
  if (!pose) return;
  const scale = cv.width / size;
  const x = pose[0] / res * scale;
  const y = cv.height - pose[1] / res * scale;
  ctx.strokeStyle = color; ctx.lineWidth = 2;
  ctx.beginPath(); ctx.arc(x, y, 6, 0, 2 * Math.PI); ctx.stroke();
  ctx.beginPath(); ctx.moveTo(x, y);
  ctx.lineTo(x + 12 * Math.cos(pose[2]), y - 12 * Math.sin(pose[2]));
  ctx.stroke();
}
function draw() {
  const fi = +slider.value, li = +levelSel.value;
  const f = frames[fi];
  const size = data.level_sizes[li], res = data.level_res[li];
  ctx.imageSmoothingEnabled = false;
  ctx.drawImage(imgs[fi][li], 0, 0, cv.width, cv.height);
  // trajectory traces up to this frame
  for (const [key, color] of [['truth', '#f55'], ['est', '#5f5']]) {
    ctx.fillStyle = color;
    for (let i = 0; i <= fi; i++) {
      const p = frames[i][key];
      if (!p) continue;
      const x = p[0] / res * (cv.width / size);
      const y = cv.height - p[1] / res * (cv.height / size);
      ctx.fillRect(x - 1, y - 1, 2, 2);
    }
  }
  mark(f.truth, '#f55', size, res);
  mark(f.est, '#5f5', size, res);
  const e = f.truth ? Math.hypot(f.est[0] - f.truth[0],
                                 f.est[1] - f.truth[1]).toFixed(3) : '?';
  info.textContent = `scan ${f.scan}  err ${e} m`;
}
slider.oninput = draw;
levelSel.onchange = draw;
let timer = null;
document.getElementById('play').onclick = function () {
  if (timer) { clearInterval(timer); timer = null; this.innerHTML = '&#9654; play'; return; }
  this.innerHTML = '&#10074;&#10074; pause';
  timer = setInterval(() => {
    slider.value = (+slider.value + 1) % frames.length; draw();
  }, 80);
};
window.onload = () => setTimeout(draw, 300);
</script></div></body></html>
"""

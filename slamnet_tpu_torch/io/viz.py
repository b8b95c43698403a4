"""Headless visualization — the WPF Simulation window replaced by PNG rendering.

Reproduces the reference UI's views (MainWindow.Draw, MainWindow.xaml.cs:215-275):
hole map as 16-bit grayscale, occupancy layers via GetBitmapData grayscale, field
edges, and the real/CoreSLAM/Hector poses in red/blue/green — but headless and
importable, per SURVEY.md §4's "make the simulator a headless, deterministic,
importable fixture".

Port of ``slamnet_tpu/io/viz.py``: maps and poses may be tensors on any
device.  ``render_frame`` imports matplotlib when it is called, so nothing
else here needs it (a machine without matplotlib runs everything but it).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import export
from .export import host


def render_frame(path: str, *, hole_map=None, hole_size: int = 0,
                 logodds=None, occ_size: int = 0,
                 physical_size: float = 40.0,
                 field_edges=None,
                 real_pose=None, estimates: Optional[dict] = None,
                 trajectory=None, title: str = "") -> None:
    """Render one frame to a PNG.

    estimates: {label: (pose f32[3], color)}; trajectory: f32[T, 3] ground truth.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ncols = int(hole_map is not None) + int(logodds is not None)
    ncols = max(ncols, 1)
    fig, axes = plt.subplots(1, ncols, figsize=(7 * ncols, 7))
    if ncols == 1:
        axes = [axes]
    ax_i = 0

    def draw_overlays(ax):
        if field_edges is not None:
            a, b = field_edges
            for k in range(len(a)):
                ax.plot([a[k][0], b[k][0]], [a[k][1], b[k][1]], "b-",
                        lw=0.8, alpha=0.5)
        if trajectory is not None:
            t = host(trajectory)
            ax.plot(t[:, 0], t[:, 1], "-", color="gray", lw=0.7, alpha=0.7)
        if real_pose is not None:
            _draw_pose(ax, real_pose, "red", "real")
        for label, (pose, color) in (estimates or {}).items():
            _draw_pose(ax, pose, color, label)
        ax.set_xlim(0, physical_size)
        ax.set_ylim(physical_size, 0)   # image convention (y down), like WPF
        ax.set_aspect("equal")
        ax.legend(loc="upper right", fontsize=8)

    if hole_map is not None:
        ax = axes[ax_i]
        ax_i += 1
        img = export.hole_map_u16(hole_map, hole_size)
        ax.imshow(img, cmap="gray", vmin=0, vmax=65535,
                  extent=[0, physical_size, physical_size, 0])
        ax.set_title(f"hole map {title}")
        draw_overlays(ax)
    if logodds is not None:
        ax = axes[ax_i]
        img = export.occupancy_bitmap(logodds, occ_size)
        ax.imshow(img, cmap="gray", vmin=0, vmax=254,
                  extent=[0, physical_size, physical_size, 0])
        ax.set_title(f"occupancy {title}")
        draw_overlays(ax)

    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def _draw_pose(ax, pose, color, label):
    p = host(pose).astype(float)
    ax.plot(p[0], p[1], "o", color=color, ms=6, label=label)
    ax.plot([p[0], p[0] + 0.8 * np.cos(p[2])],
            [p[1], p[1] + 0.8 * np.sin(p[2])], "-", color=color, lw=2)

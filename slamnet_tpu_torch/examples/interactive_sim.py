"""Interactive simulation: drive the robot with the mouse while SLAM tracks.

Port of ``examples/interactive_sim.py``, the counterpart of the reference's
WPF Simulation window (Simulation/MainWindow.xaml.cs): left-drag teleports
the lidar, right-drag aims its heading, the wheel zooms and Reset restarts
both pipelines, while Hector (and CoreSLAM) step at the lidar rate on the
device in a background thread (``io/interactive.py``).

    python -m slamnet_tpu_torch.examples.interactive_sim [--port 8801] \\
        [--world default|office] [--no-coreslam]

then open http://localhost:8801 in a browser.  ``--serve-s S`` stops after
S seconds (default: until interrupted).
"""
from __future__ import annotations

import argparse
import sys
import time

from ..io.interactive import InteractiveSession, serve
from . import device_or_exit


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--port", type=int, default=8801,
                    help="HTTP port (0 picks a free one)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default, no fallback) or cpu")
    ap.add_argument("--no-coreslam", action="store_true",
                    help="run HectorSLAM only")
    ap.add_argument("--world", choices=["default", "office"],
                    default="default",
                    help="'office' loads the multi-room loop-closure world "
                         "(sim/field.office_field)")
    ap.add_argument("--serve-s", type=float, default=None,
                    help="stop after this many seconds")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = device_or_exit(args.device, "interactive_sim")
    session = InteractiveSession(device=dev,
                                 run_coreslam=not args.no_coreslam,
                                 world=args.world)
    srv = serve(session, port=args.port)
    print(f"interactive sim at http://localhost:{srv.server_address[1]} on "
          f"{dev} (left-drag: move, right-drag: aim, wheel: zoom)",
          flush=True)
    try:
        if args.serve_s is None:
            while True:
                time.sleep(3600)
        time.sleep(args.serve_s)
    except KeyboardInterrupt:
        pass
    finally:
        session.stop()
        srv.shutdown()
        srv.server_close()
    print(f"stopped after {session.loops} scans (rate EMA "
          f"{session.scan_rate_ema:.1f} scans/s)"
          + (f", DIVERGED at {session.diverged_at}"
             if session.diverged_at is not None else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The interactive simulator of slamnet_tpu_torch on the CPU, at a small
config: steps without divergence, frames of every level and of the hole map
decode as PNGs of the right size, mouse commands move the robot, and one
HTTP round trip on port 0 (every ``urlopen`` with a 10-s timeout, the server
shut down in ``finally``).  The page is JAX's page but for its title.
"""
import base64
import inspect
import json
import struct
import urllib.request

import numpy as np
import pytest
import torch

from slamnet_tpu.io import interactive as jinteractive
from slamnet_tpu_torch.core.config import CoreSlamConfig, HectorConfig
from slamnet_tpu_torch.io import interactive

SMALL = HectorConfig(map_size=160, map_resolution=0.25, num_levels=4,
                     estimate_iterations=(7, 4, 4, 4))
SMALL_CORE = CoreSlamConfig(hole_map_size=64, obstacle_map_size=16,
                            num_candidates=64)


def _png_size(b64: str):
    raw = base64.b64decode(b64)
    assert raw[:8] == b"\x89PNG\r\n\x1a\n" and raw[12:16] == b"IHDR"
    return struct.unpack(">II", raw[16:24])


@pytest.fixture(scope="module")
def session():
    s = interactive.InteractiveSession(device="cpu", hcfg=SMALL,
                                       ccfg=SMALL_CORE, seed=2)
    for _ in range(12):
        s.step()
    return s


def test_session_steps_and_frames(session):
    assert session.loops == 12 and session.diverged_at is None
    assert session.scan_rate_ema > 0.0
    for level in range(4):
        f = session.frame(level)
        assert f["level"] == level and f["size"] == 160 >> level
        assert _png_size(f["png"]) == (f["size"], f["size"])
        assert f["levels"] == [160, 80, 40, 20] and f["has_coreslam"]
        np.testing.assert_allclose(f["hector"], f["real"], atol=0.3)
    hole = session.frame(-1)
    assert hole["level"] == -1 and _png_size(hole["png"]) == (64, 64)
    assert session.frame(9)["level"] == 3
    session.set_position(21.0, 20.0)
    session.set_heading_toward(21.0, 25.0)
    np.testing.assert_allclose(session.real_pose, [21.0, 20.0, np.pi / 2],
                               atol=1e-6)
    session.reset()
    session.step()
    assert session.loops == 1 and session.diverged_at is None
    np.testing.assert_allclose(session.frame()["real"], [20.0, 20.0, 0.0])


def test_http_round_trip(session):
    srv = interactive.serve(session, port=0)
    try:
        host, port = srv.server_address[:2]
        assert host == "127.0.0.1"
        base = f"http://{host}:{port}"
        with urllib.request.urlopen(f"{base}/state?level=1", timeout=10) as r:
            state = json.load(r)
        assert state["level"] == 1 and state["size"] == 80
        req = urllib.request.Request(
            f"{base}/pose", data=json.dumps({"x": 22.0, "y": 19.0}).encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            assert json.load(r) == {"ok": True}
        assert session.real_pose[:2].tolist() == [22.0, 19.0]
        with urllib.request.urlopen(f"{base}/", timeout=10) as r:
            page = r.read().decode()
        assert page == jinteractive._PAGE.replace(
            "__TITLE__", "slamnet_tpu_torch interactive simulation")
    finally:
        session.stop()
        srv.shutdown()
        srv.server_close()


def test_session_defaults_to_the_card():
    params = inspect.signature(interactive.InteractiveSession).parameters
    assert params["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            interactive.InteractiveSession()

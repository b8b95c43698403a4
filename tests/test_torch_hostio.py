"""slamnet_tpu_torch.hostio: the port's bindings over native/slamnet_host.cpp.

The library builds with g++ into build/ (never into native/); the C++ CARMEN
parser equals its plain twin (``io.datasets.read_carmen``) and the JAX
package's reader bit for bit on both checked-in logs, with the garbage and
truncation cases of ``tests/test_hostio.py``; the scan queue hands slots
across threads and drops when full; the .slog codec round trips and detects
corruption; the de-skew pack equals the port's and JAX's
``segments_to_cloud``.
"""
import struct
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamnet_tpu.core.scan import SegmentScan as JSegmentScan
from slamnet_tpu.core.scan import segments_to_cloud as jsegments_to_cloud
from slamnet_tpu.io import datasets as jds
from slamnet_tpu_torch import hostio, replay
from slamnet_tpu_torch.core.scan import SegmentScan, segments_to_cloud
from slamnet_tpu_torch.io import datasets


def test_library_builds_into_build_not_native():
    path = hostio.build()
    assert path.is_file() and hostio.BUILD_ROOT in path.parents
    assert hostio.library() is hostio.library()
    assert not (hostio.SOURCE.parent / "build").exists()


@pytest.mark.parametrize("path", [replay.SIM_LOOP_LOG, replay.ADVERSARIAL_LOG])
@pytest.mark.parametrize("max_scans", [None, 7])
def test_native_reader_bit_identical(path, max_scans):
    a = hostio.read_carmen_native(str(path), max_scans=max_scans)
    for b in (datasets.read_carmen(str(path), max_scans=max_scans),
              jds.read_carmen(str(path), max_scans=max_scans)):
        for name in ("ranges", "valid", "odometry", "angles", "timestamps"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        assert a.max_range == b.max_range
        assert (a.truth is None) == (b.truth is None)
        if a.truth is not None:
            np.testing.assert_array_equal(a.truth, b.truth)
    if max_scans:
        assert a.ranges.shape[0] == max_scans


def test_native_reader_garbage_and_truncation(tmp_path):
    # no FLASER line (a ROBOTLASER1-format log is the Python reader's)
    p = tmp_path / "empty.clf"
    p.write_text("# nothing here\nODOM 1 2 3 0 0 0 5 h 5\n")
    assert hostio.read_carmen_native(str(p)) is None
    q = tmp_path / "mixed.clf"
    q.write_text("FLASER 2 1.0 2.0 0 0 0 0 0 0 1 h 1\n"
                 "FLASER 3 1.0 2.0 3.0 0 0 0 0 0 0 2 h 2\n")
    with pytest.raises(ValueError):
        hostio.read_carmen_native(str(q))
    # a stray "# TRUTH" line: truths != scans -> no truth, as the twin
    r = tmp_path / "extra_truth.clf"
    r.write_text("# TRUTH 0 0 0\n"
                 "FLASER 2 1.0 2.0 0 0 0 0 0 0 1 h 1\n"
                 "# TRUTH 1 1 0\n")
    assert hostio.read_carmen_native(str(r)).truth is None
    assert datasets.read_carmen(str(r)).truth is None
    t = tmp_path / "truncated.clf"
    t.write_text("FLASER 5 1.0 2.0\n")
    with pytest.raises(ValueError):
        hostio.read_carmen_native(str(t))


def test_scan_queue_threaded_handoff_and_drop():
    slot = 64
    q = hostio.ScanQueue(capacity=4, slot_bytes=slot)
    got = []

    def consumer():
        while len(got) < 20:
            item = q.pop(timeout_ms=2000)
            if item is None:
                break
            got.append(item)

    th = threading.Thread(target=consumer)
    th.start()
    for i in range(20):
        assert q.push(struct.pack("<q", i).ljust(slot, b"\0"),
                      timeout_ms=2000) == 1
    th.join(timeout=5)
    assert [struct.unpack_from("<q", g)[0] for g in got] == list(range(20))
    assert q.dropped == 0
    small = hostio.ScanQueue(capacity=2, slot_bytes=8)
    assert small.push(b"\x00" * 8, timeout_ms=0) == 1
    assert small.push(b"\x01" * 8, timeout_ms=0) == 1
    assert small.push(b"\x02" * 8, timeout_ms=0) == 0     # full -> dropped
    assert small.dropped == 1 and len(small) == 2
    with pytest.raises(ValueError):
        small.push(b"\x00" * 3)
    small.close()
    assert small.pop(timeout_ms=0) == b"\x00" * 8


def test_slog_round_trip_and_corruption(tmp_path):
    path = str(tmp_path / "t.slog")
    n = 40
    rng = np.random.default_rng(0)
    w = hostio.SlogWriter(path, n)
    records = []
    for i in range(7):
        rec = (1000 + i, rng.normal(size=3).astype(np.float32),
               rng.uniform(0, 40, n).astype(np.float32), rng.random(n) > 0.3)
        w.append(*rec)
        records.append(rec)
    w.close()
    r = hostio.SlogReader(path)
    assert r.num_beams == n
    out = list(r)
    r.close()
    assert len(out) == 7
    for got, want in zip(out, records):
        assert got[0] == want[0]
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(a, b)
    data = bytearray(open(path, "rb").read())
    data[30] ^= 0xFF                      # flip a payload byte
    open(path, "wb").write(bytes(data))
    with pytest.raises(IOError):
        next(hostio.SlogReader(path))


def test_pack_polar_deskew_matches_segments_to_cloud():
    rng = np.random.default_rng(1)
    s, n = 3, 50
    angles = rng.uniform(0, 2 * np.pi, (s, n)).astype(np.float32)
    radii = rng.uniform(0.5, 30, (s, n)).astype(np.float32)
    valid = rng.random((s, n)) > 0.2
    poses = rng.normal(0, 1, (s, 3)).astype(np.float32)
    pts, v = hostio.pack_polar_deskew(angles, radii, valid, poses)
    cloud = segments_to_cloud(SegmentScan(*(torch.from_numpy(x) for x in (
        angles, radii, valid, poses))))
    np.testing.assert_allclose(pts, cloud.points.numpy(), atol=2e-5)
    np.testing.assert_array_equal(v, cloud.valid.numpy())
    jc = jsegments_to_cloud(JSegmentScan(*(jnp.asarray(x) for x in (
        angles, radii, valid, poses))))
    np.testing.assert_allclose(pts, np.asarray(jc.points), atol=2e-5)

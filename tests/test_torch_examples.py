"""The port's examples (``slamnet_tpu_torch/examples/``) in-process on the CPU.

Each ``main(argv)`` at a few scans on ``--device cpu``; where it is cheap,
its printed or written track and ATE equal those of the ``replay.py`` flow
it wraps (those flows are held against JAX by the other ``test_torch_*``
files), and the dataset example's Hector track stays within 1e-3 m of JAX's
on ``sim_loop.clf``.  Without a card and without ``--device cpu`` every
example exits 2 at once.
"""
import argparse
import json
import re

import numpy as np
import pytest
import torch

from slamnet_tpu_torch import hostio, replay
from slamnet_tpu_torch.core.config import CoreSlamConfig, HectorConfig
from slamnet_tpu_torch.examples import (interactive_sim, record_and_replay,
                                        replay_dataset, replay_demo)
from slamnet_tpu_torch.models import hector
from slamnet_tpu_torch.sim.trajectory import loop_trajectory

SCANS = 24


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's workers share the machine's cores,
    and oversubscribed threads slow these small full-width replays ~10x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def printed_ate(out: str, name: str) -> float:
    return float(re.search(rf"^{name}: ATE=([0-9.]+) m", out, re.M).group(1))


def test_replay_demo_is_the_replay_flows(tmp_path, capsys):
    metrics = tmp_path / "m.jsonl"
    html = tmp_path / "r.html"
    argv = ["--device", "cpu", "--pipeline", "all", "--scans", str(SCANS),
            "--metrics", str(metrics), "--html", str(html)]
    assert replay_demo.main(argv) == 0
    out = capsys.readouterr().out
    for name in ("coreslam", "particle", "graph", "hector"):
        assert re.search(rf"^{name}: ATE=.*\[OK\]$", out, re.M), out
    assert re.search(r"^graph: 1 keyframes, 0 edges, 0 loop closures$", out,
                     re.M), out
    assert html.read_text().startswith("<!DOCTYPE html>")

    _, traj, dlog = replay_demo.simulate(replay_demo.parse_args(argv), "cpu")
    # Hector: the bootstrap at the true poses, then replay.replay
    cfg = HectorConfig()
    boot = replay_demo.BOOTSTRAP
    st = replay.bootstrap(hector.init(cfg, traj[0], "cpu"), dlog, boot, cfg)
    _, want = replay.replay(st, dlog, boot, cfg)
    recs = [json.loads(ln) for ln in metrics.read_text().splitlines()]
    assert [r["scan_index"] for r in recs] == list(range(SCANS))
    got = np.asarray([r["pose"] for r in recs[boot:]], np.float32)
    np.testing.assert_array_equal(got, want.poses.numpy())
    # CoreSLAM: replay.coreslam_replay under the demo's seed + 1
    _, cout = replay.coreslam_replay(dlog, CoreSlamConfig(num_candidates=2048),
                                     seed=1)
    ate = replay.ate_of(cout.poses.numpy(), traj)[0]
    assert printed_ate(out, "coreslam") == pytest.approx(ate, abs=5e-7)


def test_replay_demo_office_dropout(capsys):
    argv = ["--device", "cpu", "--pipeline", "hector", "--scans", "16",
            "--trajectory", "office", "--dropout", "0.1", "--seed", "3"]
    assert replay_demo.main(argv) == 0
    args = replay_demo.parse_args(argv)
    _, traj, dlog = replay_demo.simulate(args, "cpu")
    assert traj.shape == (16, 3) and dlog.points.shape == (16, 400, 2)
    hits = dlog.valid.float().mean()
    assert 0.5 < hits < 0.95                  # dropouts taken from the hits
    assert "hector: ATE=" in capsys.readouterr().out


def test_replay_dataset_sim_loop(tmp_path, capsys):
    n = 40
    assert replay_dataset.main(["--device", "cpu", "--max-scans", str(n),
                                "--out-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert f"{n} scans x 180 beams" in out
    track = [json.loads(ln) for ln in
             (tmp_path / "track.jsonl").read_text().splitlines()]
    assert [r["t"] for r in track] == list(range(n))
    data = replay.load_carmen(replay.SIM_LOOP_LOG, "cpu", max_scans=n)
    _, _, want = replay.carmen_replay(data, *replay.dataset_config())
    for key, poses in (("hector", want.hector), ("coreslam", want.coreslam)):
        assert [r[key] for r in track] == \
            [[round(float(x), 4) for x in p] for p in poses.numpy()]
    # JAX's Hector track over the same scans (dataset_ref_tracks.json)
    jax_track = replay.dataset_reference_track("sim_loop")[:n]
    got = np.asarray([r["hector"] for r in track])
    assert np.abs(got[:, :2] - jax_track[:, :2]).max() <= 1e-3 + 5e-5
    for png in ("hole_map.png", "occupancy.png"):
        assert (tmp_path / png).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_replay_dataset_adversarial_truth(tmp_path, capsys):
    assert replay_dataset.main([
        "--device", "cpu", "--log", str(replay.ADVERSARIAL_LOG), "--robust",
        "--max-scans", "30", "--map-size-m", "40", "--out-dir",
        str(tmp_path)]) == 0
    out = capsys.readouterr().out
    data = replay.load_carmen(replay.ADVERSARIAL_LOG, "cpu", max_scans=30)
    _, _, res = replay.carmen_replay(data, *replay.dataset_config(True))
    m = replay.dataset_metrics(data, res)
    assert (f"hector {m['hector_ate_m']:.3f}/{m['hector_max_err_m']:.3f}"
            in out), out


def test_record_and_replay(tmp_path, capsys):
    path = tmp_path / "demo.slog"
    assert record_and_replay.main(["--device", "cpu", "--scans", str(SCANS),
                                   "--out", str(path)]) == 0
    out = capsys.readouterr().out
    assert re.search(rf"^replayed {SCANS} scans from log on cpu: .*"
                     r"dropped=0 \[OK\]$", out, re.M), out
    reader = hostio.SlogReader(str(path))
    try:
        odoms = np.asarray([odom for _, odom, _, _ in reader])
    finally:
        reader.close()
    np.testing.assert_array_equal(odoms,
                                  loop_trajectory(speed=0.3)[:SCANS])


def test_interactive_sim_serves_and_stops(capsys):
    assert interactive_sim.main(["--device", "cpu", "--port", "0",
                                 "--serve-s", "1.5", "--no-coreslam"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"^interactive sim at http://localhost:\d+ on cpu", out,
                     re.M), out
    loops = int(re.search(r"^stopped after (\d+) scans", out, re.M).group(1))
    assert loops > 0 and "DIVERGED" not in out


@pytest.mark.parametrize("module", [replay_demo, replay_dataset,
                                    record_and_replay, interactive_sim])
def test_no_card_exits_at_once(monkeypatch, capsys, module):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        module.main([])
    assert e.value.code == 2
    cap = capsys.readouterr()
    assert cap.out == "" and "no CUDA device" in cap.err


def test_cli_defaults_are_the_card():
    for module in (replay_demo, replay_dataset, record_and_replay,
                   interactive_sim):
        args = module.parse_args([])
        assert isinstance(args, argparse.Namespace) and args.device == "cuda"

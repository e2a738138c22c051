"""chip_smoke.py: its phases at tiny sizes on the CPU, and its refusal to
run without a GPU.  The full-size run needs the card (`python
chip_smoke.py`); see README."""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke as cs

REPO = Path(__file__).resolve().parents[1]


def _run(cwd, env_extra):
    import os

    env = dict(os.environ, **env_extra)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_exits_nonzero_without_gpu():
    r = _run(REPO, {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(tmp_path, {"JAX_PLATFORMS": "cpu", "PYTHONPATH": ""})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_device_phase_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        cs.phase_device()
    assert e.value.code == 2
    assert cs.phase_device(require_gpu=False)["platform"] == "cpu"


def test_check_raises_gate_error():
    cs.check(True, "fine")
    with pytest.raises(cs.GateError, match="ATE"):
        cs.check(False, "ATE 99 cm")


def test_frontend_phase_tiny():
    r = cs.phase_frontend(64, 96, 2, 64)
    assert set(r) == {"thr0", "thr7"}
    assert all(v["kp_diff"] == 0 and v["desc_diff"] == 0 for v in r.values())


def test_odometry_phase_tiny():
    r = cs.phase_odometry(96, 128, 6)
    assert r["ate_cm"] < cs.ODOM_ATE_CM and r["tracked"] == 1.0


def test_ba_phase_tiny():
    r = cs.phase_ba(4, 64, 3, 4)
    assert r["cost_rel_diff_vs_cpu"] == 0.0
    assert r["cost_final"] < r["cost0"]


def test_sharded_ba_phase_tiny():
    r = cs.phase_sharded_ba(4, 4, 63, 3, 4)
    assert r["cost_rel_diff"] < cs.BA_COST_RTOL


def test_scan_helpers_tiny():
    """The RGB-D lap plumbing of the slam_rgbd and sharded_scan phases."""
    seq, depth = cs.noisy_lap(96, 128, 12, 10)
    cfg = cs.lap_config(96, 128)
    final, out, poses, t = cs.run_scan(seq.gray, depth, seq.intrinsics, cfg)
    assert poses.shape == (12, 4, 4)
    r = cs.scan_report(seq, final, out, poses, t, t)
    assert r["frames"] == 12 and r["keyframes"] >= 1
    assert np.isfinite(r["ate_cm"])

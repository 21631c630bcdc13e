"""chip_smoke.py: its refusal contract and its phase functions at tiny
sizes on the CPU (the checks themselves run on the card)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_smoke(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=300)


def _assert_refused(proc):
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("args", [(), ("--four-cards",)])
def test_refuses_cpu_only_device(args):
    proc = _run_smoke(REPO, *args)
    _assert_refused(proc)
    assert "GPU" in proc.stderr


def test_refuses_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    _assert_refused(_run_smoke(str(tmp_path)))


def test_phase_slam_fleet_tiny():
    out = cs.phase_slam_fleet(B=2, duration=3.0, n_oracle=2)
    assert out["slam_fleet_pose_err_m"] < cs.POSE_TOL_M


def test_phase_mcl_tiny():
    out = cs.phase_mcl(n=1 << 12, duration=15.0)
    assert out["mcl_track_err_m"] < cs.PF_TRACK_TOL_M


def test_phase_combined_tiny():
    cs.phase_combined(n=1 << 11, duration=2.0)


def test_phase_sections_tiny():
    cs.phase_sections(duration=1.0, b_slam256=2, b_fls=2, b_loc=2, b_loc_wide=3,
                      b_ekf15=2, b_dr=2, b_rc=2, t_rc=8)


def test_phase_slam_sharded_on_cpu_mesh():
    """The multi-card SLAM phase on four of the eight virtual CPU devices:
    the sharded fleet (the one-device program on each device) is bitwise
    the one-device fleet."""
    out = cs.phase_slam_sharded(B=8, duration=2.0)
    assert out["slam_shard_mismatch"] == 0


def test_phase_mcl_sharded_on_cpu_mesh():
    out = cs.phase_mcl_sharded(duration=15.0, n=4 * 2048)
    assert out["mcl_bank_mismatch"] == 0


@pytest.mark.parametrize("n", [1 << 12, 1 << 15])
def test_resample_ancestor_check(n):
    mism, tie_tol, worst = cs.resample_ancestor_check(n, seed=n)
    assert 0 <= mism < n and worst <= tie_tol


def test_phase_failure_reported_without_ok_line(monkeypatch, capsys):
    """main() runs every phase, reports the failed ones and prints no ok
    line (device check stubbed: this process is on the CPU)."""
    import jax

    class FakeGpu:
        platform, device_kind = "gpu", "test"

    def boom(**_):
        raise cs.PhaseFailure("forced")

    monkeypatch.setattr(jax, "devices", lambda: [FakeGpu()])
    monkeypatch.setattr(cs, "gpu_name_and_power", lambda: "stub, 0 W")
    for name in ("phase_slam_fleet", "phase_mcl", "phase_combined", "phase_sections"):
        monkeypatch.setattr(cs, name, boom)
    assert cs.main([]) == 1
    out = capsys.readouterr().out
    assert "FAIL" in out and '"ok"' not in out


@pytest.mark.gpu
def test_chip_smoke_on_gpu():
    """The whole smoke run on the card (skips on CPU)."""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stdout[-4000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"

"""bench.py's harness: it refuses to measure without a GPU, reports a
failed or skipped section with a non-zero exit while still re-emitting the
JSON line,
and its slope cancels fixed per-call costs."""

import json
import os
import subprocess
import sys

import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "bench.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "GPU" in proc.stderr


def test_failed_section_recorded_and_json_reemitted(capsys, monkeypatch):
    monkeypatch.setattr(bench, "FAILED", [])

    def boom():
        raise RuntimeError("forced")

    bench.section("ok-section", lambda: bench.RESULT["secondary"].update(x=1.0))
    bench.section("bad-section", boom)
    assert bench.FAILED == ["bad-section"]
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert len(lines) == 2 and lines[-1]["secondary"]["x"] == 1.0


def test_skipped_section_recorded(capsys, monkeypatch):
    """A section dropped for want of budget is recorded, so the run exits
    non-zero instead of passing with a metric missing."""
    monkeypatch.setattr(bench, "SKIPPED", [])
    monkeypatch.setattr(bench, "remaining", lambda: 10.0)
    ran = []
    bench.section("late-section", lambda: ran.append(1), floor_s=40.0)
    assert ran == [] and bench.SKIPPED == ["late-section"]
    assert "SKIP late-section" in capsys.readouterr().err


def test_slope_cancels_fixed_cost():
    import time

    def fn(units):
        time.sleep(0.02 + 0.002 * units)
        return 0.0

    per_unit = bench.slope(fn, (5,), (25,), 5, 25, reps=2)
    assert 0.0015 < per_unit < 0.0035


def test_hlo_scopes_find_every_leg():
    """The named scopes of the SLAM and PF steps survive into the compiled
    module's metadata, which is how ``trace_summary`` attributes kernels."""
    import jax

    from smarc_navigation_tpu.configs import PFConfig
    from smarc_navigation_tpu.io import sim, workloads
    from smarc_navigation_tpu.models import ekf_slam as slam
    from smarc_navigation_tpu.models import particle_filter as pf

    cfg = workloads.combined_slam_cfg()
    params = slam.make_params(cfg)
    tl = workloads.slam_fleet_timelines(cfg, 0.5, 2)
    hlo = jax.jit(lambda t: slam.run_fleet(t, params, cfg)[0].mu.sum()).lower(tl).compile().as_text()
    pcfg = PFConfig(particle_count=256)
    pparams = pf.make_params(pcfg)
    ptl = pf.pf_timeline(sim.simulate(sim.MissionSpec(duration_s=2.0, gps_surface_z=-100.0)))
    hlo += jax.jit(lambda t: pf.run(t, pparams, pcfg, scheme="systematic")[1]["mean"].sum()
                   ).lower(ptl).compile().as_text()
    paths = " ".join(bench.hlo_scopes(hlo).values())
    missing = [leg for leg in bench.LEGS if leg not in paths]
    assert missing == []


def test_trace_summary_of_a_host_only_trace(tmp_path):
    """A trace with no device plane (CPU) reduces to an empty summary."""
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda x: jnp.sum(jnp.sin(x)))
    assert bench.traced_call(str(tmp_path), "cpu", f, jnp.ones(64)) == {}

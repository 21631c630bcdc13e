"""Every fleet entry point against the independent f64 NumPy oracles,
mission by mission, over seeds: localization, the 15-state EKF, the dual
pair, and the SLAM fleets (MBES full/marginal, FLS). The fleets are the
per-mission filters vmapped over a batched timeline; these tests pin the
batched outputs to the oracles, not to the code they are built from."""

import dataclasses

import jax
import numpy as np
import pytest

from smarc_navigation_tpu.configs import EKFSlamConfig
from smarc_navigation_tpu.io import sim, workloads
from smarc_navigation_tpu.models import ekf_15state as e15
from smarc_navigation_tpu.models import ekf_localization as loc
from smarc_navigation_tpu.models import ekf_slam as slam
from smarc_navigation_tpu.parallel import fleet
from tests.oracles import ekf15_oracle as o15
from tests.oracles import ekf_loc_oracle as oloc

from test_ekf_localization import CFG_SIM, _timeline_np as loc_arrays
from test_slam_fleet import _fls_tls, _slam_tls, assert_fleet_matches_oracle


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_loc_fleet_matches_oracle(seed):
    """Two lanes share the landmark map (same seed) but not the sensor
    noise; each lane matches the oracle's association decisions exactly."""
    missions = [sim.simulate(sim.MissionSpec(
        duration_s=20.0, num_landmarks=12, dvl_std=std, imu_rpy_std=0.002,
        mbes_std=0.05, seed=seed)) for std in (0.02, 0.04)]
    params = loc.make_params(missions[0].landmarks, CFG_SIM)
    tls = [loc.loc_timeline(m, CFG_SIM) for m in missions]
    batched = fleet.batch_timelines(tls)
    _, out = jax.jit(lambda t: loc.run_fleet(t, params, CFG_SIM))(batched)
    for b, tl in enumerate(tls):
        mus_o, matches_o = oloc.run_oracle(CFG_SIM, params.map_pos, loc_arrays(tl))
        got = np.asarray(out["matches"])[:, b]
        assert (got == matches_o).mean() == 1.0, (seed, b)
        err = np.linalg.norm(np.asarray(out["mu"])[:, b, :3] - mus_o[:, :3], axis=-1)
        assert err.max() < 5e-2, (seed, b, err.max())
    assert int((np.asarray(out["matches"]) >= 0).sum()) > 0


def _ekf15_oracle_track(tl, cfg):
    ticks = np.asarray(tl.ticks, np.float64)
    chans = {name: {"value": np.asarray(c.value, np.float64),
                    "fresh": np.asarray(c.fresh),
                    "age": np.asarray(c.age, np.float64),
                    "valid": np.asarray(c.valid)}
             for name, c in tl.channels.items()}
    oracle = o15.Oracle15(cfg.process_noise_diag, cfg.initial_cov_diag,
                          cfg.control_gains, cfg.control_limits)
    xs = np.zeros((len(ticks), 15))
    for k in range(len(ticks)):
        cmd = None
        if "cmd_vel" in chans and chans["cmd_vel"]["valid"][k]:
            cmd = chans["cmd_vel"]["value"][k][0:3]
        sensors = []
        for spec in cfg.sensors:
            if spec.channel not in chans:
                continue
            ch = chans[spec.channel]
            apply = bool(ch["fresh"][k]) and ch["age"][k] < spec.timeout_s
            sensors.append((ch["value"][k][0:15], spec.mask, spec.noise_diag, apply))
        xs[k] = oracle.step(ticks[k], sensors, cmd=cmd, use_control=cfg.use_control)
    return xs


def _assert_track(x_jax, xs, tag):
    err_pos = np.linalg.norm(x_jax[:, 0:3] - xs[:, 0:3], axis=-1)
    err_att = np.abs((x_jax[:, 3:6] - xs[:, 3:6] + np.pi) % (2 * np.pi) - np.pi)
    assert err_pos.max() < 2e-2, (tag, err_pos.max())
    assert err_att.max() < 2e-3, (tag, err_att.max())


def _ekf15_missions(seed, cfg, include_gps=False):
    return [e15.ekf15_timeline(sim.simulate(sim.MissionSpec(
        duration_s=8.0, dvl_std=0.02, imu_rpy_std=0.002, depth_std=0.02,
        seed=seed + k)), cfg, include_gps=include_gps) for k in range(2)]


@pytest.mark.parametrize("seed", [0, 4])
def test_ekf15_fleet_matches_oracle(seed):
    cfg = e15.Ekf15Config(frequency=50.0)
    tls = _ekf15_missions(seed, cfg)
    final, out = jax.jit(lambda t: e15.run_fleet(t, cfg))(fleet.batch_timelines(tls))
    assert final.x.shape == (2, 15) and final.P.shape == (2, 15, 15)
    for b, tl in enumerate(tls):
        _assert_track(np.asarray(out["x"])[:, b], _ekf15_oracle_track(tl, cfg),
                      (seed, b))


@pytest.mark.parametrize("seed", [1, 5])
def test_ekf15_dual_fleet_matches_oracle(seed):
    """Both filters of the dual pair, per lane, against the oracle run with
    each filter's own tuning; the map->odom correction is batched."""
    cfg_l = e15.Ekf15Config(frequency=50.0)
    cfg_g = e15.global_config(frequency=50.0)
    tls = _ekf15_missions(seed, cfg_l, include_gps=True)
    bt = fleet.batch_timelines(tls)
    (_, out_l), (_, out_g), map_odom = jax.jit(
        lambda t: e15.run_dual_fleet(t, t, cfg_l, cfg_g))(bt)
    assert np.asarray(map_odom.trans).shape == (len(tls[0].ticks), 2, 3)
    for b, tl in enumerate(tls):
        _assert_track(np.asarray(out_l["x"])[:, b], _ekf15_oracle_track(tl, cfg_l),
                      ("local", seed, b))
        _assert_track(np.asarray(out_g["x"])[:, b], _ekf15_oracle_track(tl, cfg_g),
                      ("global", seed, b))


_SLAM_CFG = dataclasses.replace(
    EKFSlamConfig(), max_landmarks=16, max_obs=4,
    mhl_dist_mbes=1.0, q_mbes_diag=(0.1,) * 3, r_diag=(1e-3,) * 6)


@pytest.mark.parametrize("update_mode,seeds", [
    ("full", (3, 4)), ("full", (5, 6)), ("full", (7, 8)),
    ("marginal", (3, 4)), ("marginal", (9, 10)),
])
def test_slam_mbes_fleet_matches_oracle(update_mode, seeds):
    params = slam.make_params(_SLAM_CFG)
    batched = fleet.batch_timelines(_slam_tls(_SLAM_CFG, 8.0, list(seeds)))
    final, out = jax.jit(lambda t: slam.run_fleet(
        t, params, _SLAM_CFG, update_mode=update_mode))(batched)
    assert int(np.asarray(final.n_active).sum()) > 0
    assert_fleet_matches_oracle(_SLAM_CFG, batched, out, final, update_mode)


@pytest.mark.parametrize("seeds", [(1, 2), (3, 4)])
def test_slam_fls_fleet_matches_oracle(seeds):
    cfg = dataclasses.replace(workloads.fls_slam_cfg(), max_landmarks=16)
    params = slam.make_params(cfg)
    batched = fleet.batch_timelines(_fls_tls(cfg, 5.0, list(seeds)))
    final, out = jax.jit(lambda t: slam.run_fleet(t, params, cfg))(batched)
    assert int(np.asarray(final.n_active).min()) > 0
    assert_fleet_matches_oracle(cfg, batched, out, final, "full", sensors=("fls",))


def test_slam_fleet_lane_is_the_mission():
    """A fleet lane replays exactly the mission in that lane: permuting the
    missions permutes the outputs (no cross-lane leakage)."""
    params = slam.make_params(_SLAM_CFG)
    tls = _slam_tls(_SLAM_CFG, 3.0, [1, 2])
    run = jax.jit(lambda t: slam.run_fleet(t, params, _SLAM_CFG))
    _, out_a = run(fleet.batch_timelines(tls))
    _, out_b = run(fleet.batch_timelines(tls[::-1]))
    np.testing.assert_array_equal(np.asarray(out_a["matched_mbes"])[:, 0],
                                  np.asarray(out_b["matched_mbes"])[:, 1])
    np.testing.assert_allclose(np.asarray(out_a["mu"])[:, 0],
                               np.asarray(out_b["mu"])[:, 1], atol=1e-6)

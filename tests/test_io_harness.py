import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smarc_navigation_tpu.io import map_server, observability, replay, sim
from smarc_navigation_tpu.models import dead_reckoning as dr
from smarc_navigation_tpu.ops import raycast
from smarc_navigation_tpu.configs import DRConfig, SAMConfig


def test_chunked_replay_matches_single_scan(tmp_path):
    m = sim.simulate(sim.MissionSpec(duration_s=20.0))
    tl = dr.sam_timeline(m)
    cfg, sam_cfg = DRConfig(), SAMConfig()

    def step(state, tick):
        return dr.dr_step(cfg, sam_cfg, state, tick)

    full = np.asarray(dr.run_sam_dr(tl))
    final, out = replay.run_chunked(step, dr.dr_init(), tl, chunk_size=128)
    np.testing.assert_allclose(np.asarray(out), full, atol=1e-5)


def test_checkpoint_resume(tmp_path):
    m = sim.simulate(sim.MissionSpec(duration_s=20.0))
    tl = dr.sam_timeline(m)
    cfg, sam_cfg = DRConfig(), SAMConfig()

    def step(state, tick):
        return dr.dr_step(cfg, sam_cfg, state, tick)

    ck = str(tmp_path / "ck")
    final1, out1 = replay.run_chunked(step, dr.dr_init(), tl, chunk_size=128,
                                      ckpt_dir=ck, ckpt_every_chunks=2)
    assert replay.latest_checkpoint(ck) is not None
    # resume from latest: replays only the tail, final state identical
    final2, out_tail = replay.run_chunked(step, dr.dr_init(), tl, chunk_size=128,
                                          ckpt_dir=ck, ckpt_every_chunks=2)
    np.testing.assert_allclose(np.asarray(final1.pos), np.asarray(final2.pos), atol=1e-6)


def test_replay_nan_guard():
    m = sim.simulate(sim.MissionSpec(duration_s=5.0))
    tl = dr.sam_timeline(m)

    def bad_step(state, tick):
        state = state._replace(pos=state.pos / 0.0)
        return state, state.pos

    with pytest.raises(replay.ReplayError):
        replay.run_chunked(bad_step, dr.dr_init(), tl, chunk_size=64)


def test_map_server_yaml(tmp_path):
    yml = tmp_path / "map.yaml"
    yml.write_text(
        """
world:
  - position: {x: 1.0, y: 2.0, z: -95.0}
  - position: {x: 3.0, y: 4.0, z: -80.0}
  - position: {x: 5.0, y: 6.0, z: -99.0}
"""
    )
    lm = map_server.parse_map_yaml(str(yml), rocks_depth=-90.0)
    assert lm.shape == (2, 3)
    np.testing.assert_allclose(lm[:, 0], [1.0, 5.0])

    npz = str(tmp_path / "map.npz")
    map_server.save_map(npz, lm)
    lm2, ids = map_server.load_map(npz)
    np.testing.assert_allclose(lm2, lm)


def test_observability_outputs(tmp_path):
    t = np.linspace(0, 10, 101)
    gt = np.stack([t, np.sin(t), -1 + 0 * t, 0 * t, 0 * t, 0.1 * t], -1)
    est = gt + 0.05
    chans = observability.flatten_odometry(est, twist=np.zeros((101, 6)))
    assert set(chans) >= {"x", "y", "depth", "roll", "pitch", "yaw", "u", "r"}
    png = str(tmp_path / "dash.png")
    stats = observability.error_dashboard(t, {"est": est}, gt, path=png)
    assert os.path.exists(png) and os.path.getsize(png) > 1000
    assert stats["est"]["final_error"] < 0.1
    rep = observability.run_report(est, gt, path=str(tmp_path / "report.json"))
    assert "rmse_pos" in rep and os.path.exists(tmp_path / "report.json")


def test_raycast_ping():
    spec = raycast.MBESSpec(num_beams=64, floor_z=-15.0, rock_radius=1.5)
    pose = jnp.asarray([0.0, 0.0, -2.0, 0.0, 0.0, 0.0])
    landmarks = jnp.asarray([[0.0, 5.0, -14.0], [0.0, -500.0, -14.0]])
    mask = jnp.asarray([True, False])  # second landmark masked out
    ranges, intens = raycast.render_ping(pose, landmarks, mask, spec)
    ranges, intens = np.asarray(ranges), np.asarray(intens)
    assert (intens >= 1.0).all() and (intens == 10.0).any()
    # rock hits are closer than the floor along those beams
    rock_beams = intens == 10.0
    assert ranges[rock_beams].min() < 13.5
    # straight-down beam sees the floor 13 m away
    mid = 32
    assert abs(ranges[mid] - 13.0) < 0.2

    # full loop: ping -> detections in base frame near the true landmark
    pts, dmask = raycast.ping_detections(pose, landmarks, mask, spec)
    assert int(jnp.sum(dmask)) >= 1
    p = np.asarray(pts)[np.asarray(dmask)][0]
    # base frame: landmark at y=5, z=-12 relative to vehicle
    assert abs(p[1] - 5.0) < 1.5 and abs(p[2] - (-12.0)) < 1.5


def test_raycast_no_landmarks_sees_floor_only():
    spec = raycast.MBESSpec()
    pose = jnp.zeros(6).at[2].set(-2.0)
    lm = jnp.zeros((4, 3))
    mask = jnp.zeros(4, bool)
    ranges, intens = raycast.render_ping(pose, lm, mask, spec)
    assert (np.asarray(intens) == spec.base_intensity).all()
    pts, dmask = raycast.ping_detections(pose, lm, mask, spec)
    assert int(jnp.sum(dmask)) == 0


def test_nees_nis_consistency_metrics():
    """NEES/NIS of synthetic Gaussian errors average to the state dimension."""
    from smarc_navigation_tpu.io import metrics as mx

    rng = np.random.default_rng(0)
    T, n = 4000, 3
    L = np.linalg.cholesky(np.array([[2.0, 0.3, 0.0], [0.3, 1.0, 0.1], [0.0, 0.1, 0.5]]))
    errs = (L @ rng.normal(size=(n, T))).T
    Sigma = np.tile(L @ L.T, (T, 1, 1))
    nees = np.asarray(mx.nees(jnp.asarray(errs, jnp.float32), jnp.asarray(Sigma, jnp.float32)))
    assert abs(nees.mean() - n) < 0.2, nees.mean()
    nis = np.asarray(mx.nis(jnp.asarray(errs, jnp.float32), jnp.asarray(Sigma, jnp.float32),
                            mask=jnp.ones(T, bool)))
    assert abs(nis.mean() - n) < 0.2


def test_event_channel_surfaces_dropped_detections():
    """Saturated event channels must not lose measurements silently:
    both binners report the dropped count and build_timeline exposes it."""
    import warnings
    from smarc_navigation_tpu.ops import timeline as tl

    ticks = np.arange(4, dtype=np.float64)
    # 5 detections all landing on tick 1, max_per_tick=2 -> 3 dropped;
    # plus one event after mission end -> 4 dropped total
    stamps = np.array([0.5] * 5 + [99.0])
    values = np.arange(18, dtype=np.float64).reshape(6, 3)
    burst = np.zeros(6, np.int64)

    for use_native in (False, True):
        from smarc_navigation_tpu import native
        if use_native and not native.available():
            continue
        stats = {}
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            if use_native:
                ch = tl.make_event_channel(ticks, stamps, values, burst, 2,
                                           stats=stats)
            else:
                # force the python fallback by bypassing the native call
                import unittest.mock as mock
                with mock.patch.object(native, "bin_events",
                                       lambda *a, **k: None):
                    ch = tl.make_event_channel(ticks, stamps, values, burst,
                                               2, stats=stats)
        assert stats["dropped"] == 4
        assert any("saturated" in str(x.message) for x in w)
        assert int(np.asarray(ch.mask).sum()) == 2

    # build_timeline out-param plumbing
    stats = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tl.build_timeline(0.0, 3.0, 1.0,
                          events={"mbes": (stamps, values, burst, 2)},
                          stats=stats)
    assert stats["mbes"]["dropped"] == 4


def test_native_lib_rebuilds_on_source_hash_mismatch(tmp_path, monkeypatch):
    """A cached .so is only trusted when its recorded source hash matches —
    never on mtime (fresh checkouts share mtimes)."""
    from smarc_navigation_tpu import native

    if not native.available():
        import pytest
        pytest.skip("no compiler")
    assert os.path.exists(native._STAMP)
    with open(native._STAMP) as f:
        assert f.read().strip() == native._src_hash()
    # stale/foreign stamp -> cached lib is not trusted (on a private copy:
    # the shared stamp stays valid for concurrent test workers)
    stamp = tmp_path / "libsmarcnav.so.srchash"
    stamp.write_text("deadbeef")
    monkeypatch.setattr(native, "_STAMP", str(stamp))
    assert not native._cached_lib_current(native._src_hash())


def test_twist_from_track_matches_known_motion():
    """lookupTwist equivalent (tf_listener.cpp:75): constant-velocity,
    constant-yaw-rate track -> recovered linear + angular twist."""
    from smarc_navigation_tpu.io import observability as obs

    t = np.arange(0, 20.0, 0.1)
    v, wz = np.array([0.8, -0.2, 0.05]), 0.1
    poses = np.zeros((len(t), 6))
    poses[:, 0:3] = v * t[:, None]
    poses[:, 5] = wz * t
    tw = obs.twist_from_track(t, poses, window_s=2.0)
    # after the window fills, both components are exact
    np.testing.assert_allclose(tw[50:, 0:3], np.tile(v, (len(t) - 50, 1)), atol=1e-9)
    np.testing.assert_allclose(tw[50:, 5], wz, atol=1e-9)
    np.testing.assert_allclose(tw[50:, 3:5], 0.0, atol=1e-9)
    # before any window exists: zeros, not NaN
    assert np.isfinite(tw).all() and np.allclose(tw[0], 0.0)

    scalars = obs.tf_listener_scalars(t, poses)
    assert set(scalars) >= {"roll", "pitch", "yaw", "depth", "x", "y",
                            "u", "v", "w", "p", "q", "r"}
    np.testing.assert_allclose(scalars["depth"], -poses[:, 2])
    np.testing.assert_allclose(scalars["u"][60:], v[0], atol=1e-9)


def test_save_pcd_roundtrip(tmp_path):
    """Submap PCD dump (mbes_receptor.cpp:106): ASCII v0.7 with VIEWPOINT."""
    from smarc_navigation_tpu.ops import sonar

    pts = np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0], [0.0, 0.0, 0.0]])
    mask = np.array([True, True, False])
    path = str(tmp_path / "submap_0_frame.pcd")
    n = sonar.save_pcd(path, pts, mask=mask,
                       viewpoint_trans=[10.0, 20.0, -5.0],
                       viewpoint_quat=[0.0, 0.0, 0.0, 1.0])
    assert n == 2
    lines = open(path).read().splitlines()
    assert lines[0].startswith("# .PCD v0.7")
    assert "POINTS 2" in lines
    assert "VIEWPOINT 10 20 -5 1 0 0 0" in lines
    got = np.loadtxt(lines[-2:])
    np.testing.assert_allclose(got, pts[:2])


def test_gps_world_correction_identity_and_offset():
    """publish_gps_path corrector: with identity world/odom transforms the
    correction is just the GPS pose; a known odom offset is factored out."""
    import jax.numpy as jnp
    from smarc_navigation_tpu.models import sensors
    from smarc_navigation_tpu.utils.geometry import Transform, quat_from_rpy

    q_ident = np.asarray(quat_from_rpy(jnp.zeros(3)))
    ident = Transform(rot=np.eye(3), trans=np.zeros(3))
    corr = sensors.gps_world_correction(100.0, 200.0, q_ident, ident, ident)
    np.testing.assert_allclose(np.asarray(corr.trans), [100.0, 200.0, 0.0], atol=1e-6)

    # vehicle 10 m east of its odom origin -> correction shifts back
    odom_base = Transform(rot=np.eye(3), trans=np.array([10.0, 0.0, 0.0]))
    corr2 = sensors.gps_world_correction(100.0, 200.0, q_ident, odom_base, ident)
    np.testing.assert_allclose(np.asarray(corr2.trans), [90.0, 200.0, 0.0], atol=1e-6)

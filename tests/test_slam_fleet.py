"""SLAM fleet path (``run_fleet``: the per-mission filter vmapped over a
batched timeline) against the independent f64 oracle, mission by mission:
identical association decisions and landmark counts, pose tracks within
f32 filter tolerance. Sharded fleets against unsharded ones."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment

from smarc_navigation_tpu.configs import EKFSlamConfig
from smarc_navigation_tpu.io import sim
from smarc_navigation_tpu.models import ekf_slam as slam
from smarc_navigation_tpu.ops import assignment
from smarc_navigation_tpu.ops.timeline import build_timeline
from smarc_navigation_tpu.parallel import fleet
from smarc_navigation_tpu.parallel import mesh as mesh_lib
from smarc_navigation_tpu.utils.geometry import quat_from_rpy
from tests.oracles import ekf_slam_oracle as oracle


def test_hungarian_lanes_matches_dense_jv():
    """The fleet's batched assignment (``assignment.hungarian`` vmapped over
    missions, as inside ``run_fleet``) reaches scipy's optimum per mission
    on SLAM-shaped tables: sparse gated costs + a candidate diagonal."""
    rng = np.random.default_rng(3)
    B, R, C = 4, 40, 6
    cost = np.full((B, R, C), 1e6, np.float32)
    for b in range(B):
        k = int(rng.integers(3, 25))
        rr = rng.integers(0, R - C, k)
        cc = rng.integers(0, C, k)
        cost[b, rr, cc] = rng.uniform(0, 10, k).astype(np.float32)
        for c in range(C):
            cost[b, R - C + c, c] = 1.0
    out = np.asarray(jax.vmap(assignment.hungarian)(jnp.asarray(cost)))
    for b in range(B):
        rows, cols = linear_sum_assignment(cost[b].astype(np.float64))
        co = cost[b][out[b], np.arange(C)].sum()
        assert np.isclose(co, cost[b][rows, cols].sum()), (b, out[b])
        assert len(set(out[b].tolist())) == C


def assert_fleet_matches_oracle(cfg, batched, out_f, final_f, update_mode,
                                sensors=("mbes",), oracle_kw=None, atol=5e-2):
    """Each mission of a fleet run vs the f64 oracle: identical association
    decisions on every sensor pass, identical landmark counts, pose track
    within ``atol`` metres. Returns the final oracle of each mission."""
    B = batched.ticks.shape[0]
    oracles = []
    for b in range(B):
        arrs = {s: oracle.timeline_arrays(batched, b, s) for s in sensors}
        o = oracle.OracleSLAM(cfg, update_mode, sensor=sensors[0],
                              **(oracle_kw or {}))
        a0 = arrs[sensors[0]]
        T = len(a0["ticks"])
        mus = np.zeros((T, 6))
        matched = {s: [] for s in sensors}
        for k in range(T):
            if a0["odom_valid"][k]:
                o.predict(a0["odom_value"][k][0:6])
            for s in sensors:
                z, m = arrs[s]["det_value"][k], arrs[s]["det_mask"][k]
                if a0["odom_valid"][k] and np.any(m):
                    o.use_sensor(s)
                    matched[s].append(o.da_update(z, m))
                else:
                    matched[s].append(np.full(len(z), -1))
            mus[k] = o.mu[0:6]
        assert int(final_f.n_active[b]) == o.n_active, b
        for s in sensors:
            got = np.asarray(out_f["matched_" + s][:, b])
            agree = (got == np.stack(matched[s])).mean()
            assert agree == 1.0, f"mission {b} {s}: match agreement {agree}"
        err = np.linalg.norm(np.asarray(out_f["mu"][:, b, 0:3]) - mus[:, 0:3],
                             axis=-1)
        assert err.max() < atol, (b, err.max())
        oracles.append(o)
    return oracles


def _slam_tls(cfg, duration, seeds):
    tls = []
    for s in seeds:
        m = sim.simulate(
            sim.MissionSpec(duration_s=duration, num_landmarks=12,
                            mbes_std=0.05, landmark_area_m=50.0,
                            mbes_range_m=30.0, gps_surface_z=-100.0, seed=s)
        )
        ticks = np.arange(0, duration + 1e-9, 1.0 / cfg.system_freq)
        gt = m.gt_at(ticks)
        quat = np.asarray(quat_from_rpy(jnp.asarray(gt[:, 3:6])))
        k = np.clip((ticks * m.spec.sim_hz).astype(int), 0, len(m.t) - 1)
        odom13 = np.concatenate(
            [gt[:, 0:3], quat, m.vel_body[k], m.gyro[k]], axis=1)
        det = m.streams["mbes_detections"]
        tls.append(build_timeline(
            t0=0.0, t1=duration, freq_hz=cfg.system_freq,
            channels={"odom": (ticks, odom13)},
            events={"mbes": (det["stamps"], det["values"], det["burst"],
                             cfg.max_obs)}))
    return tls


def _fls_tls(cfg, duration, seeds):
    """FLS missions of the bench's FLS fleet workload (io.workloads)."""
    from smarc_navigation_tpu.io import workloads

    return [workloads.fls_mission_timeline(cfg, duration, s, n_rocks=12)
            for s in seeds]


def test_run_fleet_matches_vmapped_run():
    cfg = dataclasses.replace(
        EKFSlamConfig(), max_landmarks=16, max_obs=4,
        mhl_dist_mbes=1.0, q_mbes_diag=(0.1,) * 3, r_diag=(1e-3,) * 6)
    params = slam.make_params(cfg)
    tls = _slam_tls(cfg, 6.0, [1, 2])
    batched = fleet.batch_timelines(tls)

    final_f, out_f = slam.run_fleet(batched, params, cfg, update_mode="full")
    assert int(np.asarray(final_f.n_active).sum()) > 0
    assert_fleet_matches_oracle(cfg, batched, out_f, final_f, "full")


def test_raycast_fleet_kernel_matches_dense():
    """Closed-loop raycast fleet sharded over the mesh's mission axis vs the
    same fleet unsharded: identical landmark counts, poses and covariances
    within f32 reassociation (the per-shard batch width changes how XLA
    vectorizes the render's reductions)."""
    from smarc_navigation_tpu.ops import raycast
    from smarc_navigation_tpu.parallel.fleet import run_raycast_fleet

    cfg = dataclasses.replace(
        EKFSlamConfig(), max_landmarks=16, max_obs=4,
        mhl_dist_mbes=1.0, q_mbes_diag=(0.1,) * 3, r_diag=(1e-3,) * 6)
    params = slam.make_params(cfg)
    rng = np.random.default_rng(0)
    B, T = 4, 40
    m = sim.simulate(sim.MissionSpec(duration_s=10.0, seed=1))
    ticks = np.arange(T) / cfg.system_freq
    gt = jnp.asarray(np.tile(m.gt_at(ticks).astype(np.float32), (B, 1, 1)))
    lms = jnp.asarray(rng.uniform([0, -20, -16], [40, 20, -12], (B, 8, 3)),
                      jnp.float32)
    lmm = jnp.ones((B, 8), bool)
    spec = raycast.MBESSpec(num_beams=32, floor_z=-16.0, rock_radius=1.2,
                            swath_rad=2.4, max_range=40.0)
    dmesh = mesh_lib.make_mesh(mission=2, particle=4)

    fin_s, (mu_s, na_s) = jax.jit(lambda g, l, m_: run_raycast_fleet(
        g, l, m_, cfg, params, spec, device_mesh=dmesh))(gt, lms, lmm)
    fin_u, (mu_u, na_u) = jax.jit(lambda g, l, m_: run_raycast_fleet(
        g, l, m_, cfg, params, spec))(gt, lms, lmm)
    assert int(np.asarray(na_u)[:, -1].sum()) > 0
    np.testing.assert_array_equal(np.asarray(na_s), np.asarray(na_u))
    np.testing.assert_allclose(np.asarray(mu_s), np.asarray(mu_u),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(fin_s.Sigma),
                               np.asarray(fin_u.Sigma), rtol=1e-4, atol=1e-6)


def test_run_fleet_fls_pass_matches_vmapped_run():
    """FLS fleets (dim=2 pixel model, incl. the sensor-extrinsic chain)
    against the f64 oracle with the same mount."""
    from smarc_navigation_tpu.utils.geometry import Transform, rotmat_from_rpy

    cfg = dataclasses.replace(
        EKFSlamConfig(), max_landmarks=8, max_obs=4,
        q_fls_diag=(4.0, 4.0), r_diag=(1e-3,) * 6)
    # nontrivial mount: 0.4 m forward, pitched down 0.08 rad
    tf_bf = Transform(
        rot=rotmat_from_rpy(jnp.asarray([0.0, 0.08, 0.0], jnp.float32)),
        trans=jnp.asarray([0.4, 0.0, -0.2], jnp.float32))
    params = slam.make_params(cfg, tf_base_fls=tf_bf)
    true_lms = np.array([[8.0, 2.0, -1.0], [12.0, -3.0, -1.0]])
    T = 30
    ticks = (np.arange(T) + 1) / cfg.system_freq
    poses = np.zeros((T, 6), np.float32)
    poses[:, 0] = 0.2 * np.arange(T)
    poses[:, 2] = -1.0
    det_stamps, det_vals, det_burst = [], [], []
    for k, t in enumerate(ticks):
        for lm in true_lms:
            z_px = np.asarray(slam.h_fls(jnp.asarray(poses[k]),
                                         jnp.asarray(lm, jnp.float32), params))
            if z_px[0] > 0:
                det_stamps.append(t)
                det_vals.append([z_px[0], z_px[1], 0.0])
                det_burst.append(k)
    tl = build_timeline(
        0.0, T / cfg.system_freq, cfg.system_freq,
        channels={"odom": (ticks, poses)},
        events={"fls": (np.asarray(det_stamps), np.asarray(det_vals),
                        np.asarray(det_burst), cfg.max_obs)},
    )
    batched = fleet.batch_timelines([tl, tl])
    final_f, out_f = slam.run_fleet(batched, params, cfg, update_mode="full")
    assert int(final_f.n_active[0]) == 2
    assert_fleet_matches_oracle(
        cfg, batched, out_f, final_f, "full", sensors=("fls",),
        oracle_kw={"r_base_fls": np.asarray(tf_bf.rot, np.float64),
                   "t_base_fls": np.asarray(tf_bf.trans, np.float64)})


def test_run_fleet_mixed_sensors_matches_vmapped_run():
    """Both sensors in ONE mission (MBES pass then FLS pass per tick —
    ``ekf_slam.cpp:323``'s frame_id dispatch, both passes per tick when both
    topics delivered): the fleet path must match the f64 oracle running both
    correspondence objects on one state, predict once per tick."""
    cfg = dataclasses.replace(
        EKFSlamConfig(), max_landmarks=8, max_obs=4,
        mhl_dist_mbes=1.0, q_mbes_diag=(0.1,) * 3,
        q_fls_diag=(4.0, 4.0), r_diag=(1e-3,) * 6)
    params = slam.make_params(cfg)
    mbes_lms = np.array([[6.0, 1.5, -8.0], [10.0, -2.0, -9.0]])
    fls_lms = np.array([[8.0, 2.0, -1.0], [14.0, -3.0, -1.0]])
    T = 30
    ticks = (np.arange(T) + 1) / cfg.system_freq
    poses = np.zeros((T, 6), np.float32)
    poses[:, 0] = 0.2 * np.arange(T)
    poses[:, 2] = -1.0
    m_st, m_v, m_b = [], [], []
    f_st, f_v, f_b = [], [], []
    for k, t in enumerate(ticks):
        for lm in mbes_lms:
            z = np.asarray(slam.MBES.h(jnp.asarray(poses[k]),
                                       jnp.asarray(lm, jnp.float32), params))
            if np.linalg.norm(z) < 12.0:
                m_st.append(t)
                m_v.append(z)
                m_b.append(k)
        for lm in fls_lms:
            z_px = np.asarray(slam.h_fls(jnp.asarray(poses[k]),
                                         jnp.asarray(lm, jnp.float32), params))
            if z_px[0] > 0:
                f_st.append(t)
                f_v.append([z_px[0], z_px[1], 0.0])
                f_b.append(k)
    tl = build_timeline(
        0.0, T / cfg.system_freq, cfg.system_freq,
        channels={"odom": (ticks, poses)},
        events={
            "mbes": (np.asarray(m_st), np.asarray(m_v), np.asarray(m_b),
                     cfg.max_obs),
            "fls": (np.asarray(f_st), np.asarray(f_v), np.asarray(f_b),
                    cfg.max_obs),
        },
    )
    batched = fleet.batch_timelines([tl, tl])
    final_f, out_f = slam.run_fleet(batched, params, cfg, update_mode="full")
    assert int(final_f.n_active[0]) == 4  # both sensors really mapped things
    assert_fleet_matches_oracle(cfg, batched, out_f, final_f, "full",
                                sensors=("mbes", "fls"))


def test_run_fleet_nondefault_update_mode_routes_per_mission():
    """update_mode="marginal" (the reference's 9x9 writeback) is honored by
    the fleet path: every mission matches the marginal-mode oracle."""
    cfg = dataclasses.replace(
        EKFSlamConfig(), max_landmarks=8, max_obs=4,
        mhl_dist_mbes=1.0, q_mbes_diag=(0.1,) * 3, r_diag=(1e-3,) * 6)
    params = slam.make_params(cfg)
    tls = _slam_tls(cfg, 3.0, [1, 2])
    batched = fleet.batch_timelines(tls)
    final_f, out_f = slam.run_fleet(batched, params, cfg,
                                    update_mode="marginal")
    assert_fleet_matches_oracle(cfg, batched, out_f, final_f, "marginal")


def test_run_fleet_capacity_denial_matches_dense():
    """Bank saturation through the fleet path: once the L-slot bank fills,
    further adds are denied exactly where the oracle denies them."""
    cfg = dataclasses.replace(
        EKFSlamConfig(), max_landmarks=3, max_obs=4,
        mhl_dist_mbes=1.0, q_mbes_diag=(0.1,) * 3, r_diag=(1e-3,) * 6)
    params = slam.make_params(cfg)
    # 8 well-separated true landmarks observed along a straight line:
    # the 3-slot bank must fill and then deny further adds
    true_lms = np.array(
        [[4.0 + 3.0 * i, 2.0 * (-1) ** i, -8.0 - 0.3 * i] for i in range(8)])
    T = 40
    ticks = (np.arange(T) + 1) / cfg.system_freq
    poses = np.zeros((T, 6), np.float32)
    poses[:, 0] = 0.5 * np.arange(T)
    poses[:, 2] = -1.0
    st_, v_, b_ = [], [], []
    for k in range(T):
        for lm in true_lms:
            z = np.asarray(slam.MBES.h(jnp.asarray(poses[k]),
                                       jnp.asarray(lm, jnp.float32), params))
            if np.linalg.norm(z) < 8.0:
                st_.append(ticks[k])
                v_.append(z)
                b_.append(k)
    tl = build_timeline(
        0.0, T / cfg.system_freq, cfg.system_freq,
        channels={"odom": (ticks, poses)},
        events={"mbes": (np.asarray(st_), np.asarray(v_), np.asarray(b_),
                         cfg.max_obs)})
    batched = fleet.batch_timelines([tl, tl])
    final_f, out_f = slam.run_fleet(batched, params, cfg, update_mode="full")
    assert int(final_f.n_active[0]) == cfg.max_landmarks  # really saturated
    assert_fleet_matches_oracle(cfg, batched, out_f, final_f, "full")


def test_slam_fleet_sharded_bitwise():
    """``run_fleet(device_mesh=...)``: missions sharded over the mesh's
    mission axis (one-device program per device) give bitwise the
    unsharded fleet's outputs and states, themselves sharded over the
    mission devices."""
    cfg = dataclasses.replace(
        EKFSlamConfig(), max_landmarks=8, max_obs=4,
        mhl_dist_mbes=1.0, q_mbes_diag=(0.1,) * 3, r_diag=(1e-3,) * 6)
    params = slam.make_params(cfg)
    batched = fleet.batch_timelines(_slam_tls(cfg, 3.0, [1, 2, 3, 4]))
    dmesh = mesh_lib.make_mesh(mission=2, particle=4)
    fin_s, out_s = slam.run_fleet(batched, params, cfg, device_mesh=dmesh)
    fin_u, out_u = jax.jit(lambda t: slam.run_fleet(t, params, cfg))(batched)
    assert int(np.asarray(fin_u.n_active).sum()) > 0
    assert len(fin_s.mu.sharding.device_set) == 2
    assert len(out_s["mu"].sharding.device_set) == 2
    assert out_s["mu"].shape == out_u["mu"].shape
    for a, b in zip(jax.tree_util.tree_leaves((fin_s, out_s)),
                    jax.tree_util.tree_leaves((fin_u, out_u))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_slam_fleet_sharded_refuses_tracing():
    """The mission-sharded fleet dispatches one program per device, which a
    trace cannot hold: under ``jit`` it says so instead of compiling an
    SPMD program whose rounding differs from one device's."""
    cfg = dataclasses.replace(EKFSlamConfig(), max_landmarks=4, max_obs=2)
    params = slam.make_params(cfg)
    batched = fleet.batch_timelines(_slam_tls(cfg, 1.0, [1, 2]))
    dmesh = mesh_lib.make_mesh(mission=2, particle=4)
    with pytest.raises(TypeError, match="outside jit"):
        jax.jit(lambda t: slam.run_fleet(t, params, cfg, device_mesh=dmesh))(batched)
    with pytest.raises(ValueError, match="not divisible"):
        slam.run_fleet(fleet.batch_timelines(_slam_tls(cfg, 1.0, [1, 2, 3])),
                       params, cfg, device_mesh=dmesh)

"""Shared benchmark workload builders.

Single source for the mission timelines that ``bench.py`` times and that
``chip_smoke.py`` checks, so both always see the same workload.

The shapes here mirror the reference's operating envelope: SLAM missions at
the 10 Hz ``ekf_slam.launch:23`` tick with simulated MBES detections, and
the PF mission at the ``auv_pf.py`` GPS-update cadence.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..configs import EKFSlamConfig


def combined_slam_cfg() -> EKFSlamConfig:
    """The SLAM config of the combined north-star workload (bench section 3
    and the L=64 headline section share it)."""
    return dataclasses.replace(
        EKFSlamConfig(),
        max_landmarks=64,
        max_obs=8,
        mhl_dist_mbes=1.0,
        q_mbes_diag=(0.1, 0.1, 0.1),
        r_diag=(1e-3,) * 6,
    )


def slam_mission_timeline(cfg: EKFSlamConfig, duration: float, seed: int):
    """One simulated SLAM mission -> Timeline (odom + gps + diving channels,
    MBES detection events). Identical to what bench.py has always timed."""
    import jax.numpy as jnp

    from ..io import sim
    from ..ops.timeline import build_timeline
    from ..utils.geometry import quat_from_rpy_np

    m = sim.simulate(
        sim.MissionSpec(
            duration_s=duration,
            num_landmarks=20,
            mbes_std=0.05,
            landmark_area_m=60.0,
            mbes_range_m=30.0,
            gps_surface_z=-100.0,
            gps_std=0.3,
            seed=seed,
        )
    )
    ticks = np.arange(0, duration + 1e-9, 1.0 / cfg.system_freq)
    gt = m.gt_at(ticks)
    quat = quat_from_rpy_np(gt[:, 3:6])
    k = np.clip((ticks * m.spec.sim_hz).astype(int), 0, len(m.t) - 1)
    odom13 = np.concatenate(
        [gt[:, 0:3], quat, m.vel_body[k], m.gyro[k]], axis=1
    )
    det = m.streams["mbes_detections"]
    gps = m.streams["gps"]
    return build_timeline(
        t0=0.0,
        t1=duration,
        freq_hz=cfg.system_freq,
        channels={
            "odom": (ticks, odom13),
            "gps": (gps["stamps"], gps["values"]),
            "diving": (ticks, np.zeros((len(ticks), 1))),
        },
        events={
            "mbes": (det["stamps"], det["values"], det["burst"], cfg.max_obs)
        },
    )


def slam256_cfg() -> EKFSlamConfig:
    """SLAM at the reference's own launch tunings (``ekf_slam.launch:23-30``:
    mhl_mbes 0.12, Q_mbes diag 200, R 1e-3) with a padded 256-slot bank."""
    return dataclasses.replace(EKFSlamConfig(), max_landmarks=256, max_obs=8)


def fls_slam_cfg() -> EKFSlamConfig:
    """SLAM on forward-looking-sonar pixel detections, 64 landmark slots."""
    return dataclasses.replace(
        EKFSlamConfig(), max_landmarks=64, max_obs=8,
        mhl_dist_fls=3.0, q_fls_diag=(4.0, 4.0), r_diag=(1e-3,) * 6)


def fls_mission_timeline(cfg: EKFSlamConfig, duration: float, seed: int,
                         n_rocks: int = 24):
    """One FLS mission: a forward run (0.15 m/tick, gentle yaw weave) past
    seafloor rocks, identity sensor mount, pixel detections of every rock
    ahead within 12 m with 0.5 px noise."""
    from ..ops.timeline import build_timeline

    scale = 400.0 / 17.0
    T = int(duration * cfg.system_freq)
    rng = np.random.default_rng(500 + seed)
    lms = np.column_stack([rng.uniform(5.0, 5.0 + 0.15 * T, n_rocks),
                           rng.uniform(-6.0, 6.0, n_rocks),
                           rng.uniform(-2.5, -1.0, n_rocks)])
    ticks = (np.arange(T) + 1) / cfg.system_freq
    poses = np.zeros((T, 6))
    poses[:, 0] = 0.15 * np.arange(T)
    poses[:, 2] = -1.5
    poses[:, 5] = 0.15 * np.sin(0.05 * np.arange(T))
    # identity extrinsic: v = R(yaw)^T (lm - p), pixels in numpy
    cy, sy = np.cos(poses[:, 5]), np.sin(poses[:, 5])
    d = lms[None, :, :] - poses[:, None, 0:3]                    # (T, N, 3)
    v0 = cy[:, None] * d[:, :, 0] + sy[:, None] * d[:, :, 1]
    v1 = -sy[:, None] * d[:, :, 0] + cy[:, None] * d[:, :, 1]
    v2 = d[:, :, 2]
    vis = (v0 > 0.5) & (np.hypot(v0, v2) < 12.0)
    px0 = scale * np.hypot(v0, v2) + rng.normal(0, 0.5, v0.shape)
    px1 = -scale * v1 + rng.normal(0, 0.5, v0.shape)
    kk, nn = np.nonzero(vis)
    return build_timeline(
        0.0, duration, cfg.system_freq,
        channels={"odom": (ticks, poses.astype(np.float32))},
        events={"fls": (ticks[kk],
                        np.column_stack([px0[kk, nn], px1[kk, nn],
                                         np.zeros(len(kk))]).astype(np.float32),
                        kk, cfg.max_obs)})


def fls_fleet_timelines(cfg: EKFSlamConfig, duration: float, B: int):
    """B-mission batched FLS Timeline: 16 distinct missions tiled to B."""
    from ..parallel import fleet

    tls = [fls_mission_timeline(cfg, duration, seed=b) for b in range(min(B, 16))]
    tls = (tls * ((B + len(tls) - 1) // len(tls)))[:B]
    return fleet.batch_timelines(tls)


def slam_fleet_timelines(cfg: EKFSlamConfig, duration: float, B: int):
    """B-mission batched SLAM Timeline: 16 distinct missions tiled to B."""
    from ..parallel import fleet

    tls = [slam_mission_timeline(cfg, duration, seed=b) for b in range(min(B, 16))]
    tls = (tls * ((B + len(tls) - 1) // len(tls)))[:B]
    return fleet.batch_timelines(tls)


def combined_workload(slam_cfg: EKFSlamConfig, duration: float, pf_seed: int = 3):
    """The BASELINE.json north-star inputs: (B=1 SLAM timeline, PF timeline)
    for one mission replayed through BOTH estimators (bench section 3)."""
    from ..io import sim
    from ..models import particle_filter as pf

    tl_slam = slam_fleet_timelines(slam_cfg, duration, 1)
    m = sim.simulate(
        sim.MissionSpec(duration_s=duration, seed=pf_seed, gps_surface_z=-100.0)
    )
    tl_pf = pf.pf_timeline(m, freq_hz=10.0)
    return tl_slam, tl_pf


def raycast_fleet_setup(B: int, n_rocks: int = 16, seed: int = 0):
    """The closed-loop raycast fleet (BASELINE.json: 1024 batched missions
    with simulated MBES ray-cast): SLAM config, MBES spec, and B per-mission
    rock fields of ``n_rocks`` rocks. Returns (cfg, spec, lms (B, n, 3),
    lm_mask (B, n))."""
    import jax.numpy as jnp

    from ..ops import raycast

    cfg = dataclasses.replace(
        EKFSlamConfig(), max_landmarks=32, max_obs=8,
        mhl_dist_mbes=1.0, q_mbes_diag=(0.1, 0.1, 0.1), r_diag=(1e-3,) * 6)
    spec = raycast.MBESSpec(num_beams=64, floor_z=-16.0, rock_radius=1.2,
                            swath_rad=2.4, max_range=40.0)
    rng = np.random.default_rng(seed)
    lms = jnp.asarray(rng.uniform([0, -20, -16], [40, 20, -12], (B, n_rocks, 3)),
                      jnp.float32)
    return cfg, spec, lms, jnp.ones((B, n_rocks), bool)

"""Mission replay CLI — the L6 experiment harness.

Replaces the reference's roslaunch entry points + batch driver
(``*/launch/*.launch``, ``pf_loop.py``): one command simulates (or loads) a
mission, replays the requested filter stack as compiled XLA programs, and
writes a run report + error dashboard.

    python -m smarc_navigation_tpu.run demo --duration 60 --out /tmp/demo
    python -m smarc_navigation_tpu.run pf --particles 1048576 --scheme systematic
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time


def _demo(args):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from .configs import EKFSlamConfig
    from .io import observability, sim
    from .models import dead_reckoning as dr
    from .models import ekf_slam as slam

    m = sim.simulate(
        sim.MissionSpec(
            duration_s=args.duration, num_landmarks=20, mbes_std=0.05,
            dvl_std=0.02, imu_rpy_std=0.002, landmark_area_m=60.0,
            mbes_range_m=30.0, seed=args.seed,
        )
    )
    os.makedirs(args.out, exist_ok=True)

    # dead-reckoning chain
    tl_dr = dr.sam_timeline(m)
    t0 = time.perf_counter()
    # closed-form replay (identical to the scan, compiles in seconds)
    track_dr = np.asarray(jax.jit(dr.run_sam_dr_vectorized)(tl_dr))
    dt_dr = time.perf_counter() - t0

    # SLAM chain on odometry from the LoLo provider
    tlo = dr.odom_timeline(m)
    gt0 = m.gt_at(np.asarray([0.0]))[0]  # gt init (odom_provider.cpp:261-284)
    odom = np.asarray(jax.jit(lambda t: dr.run_odom_provider(t, init_pose=gt0.astype(np.float32)))(tlo))
    cfg = dataclasses.replace(
        EKFSlamConfig(), max_landmarks=64, max_obs=8, mhl_dist_mbes=1.0,
        q_mbes_diag=(0.1, 0.1, 0.1), r_diag=(1e-3,) * 6,
    )
    ticks_s = np.arange(0, args.duration + 1e-9, 1.0 / cfg.system_freq)
    idx = np.clip((ticks_s * 30.0).astype(int), 0, len(odom) - 1)
    tl_s = slam.slam_timeline(m, odom[idx], ticks_s, cfg)
    params = slam.make_params(cfg)
    t0 = time.perf_counter()
    final, out = jax.jit(lambda t: slam.run(t, params, cfg))(tl_s)
    jax.block_until_ready(final.mu)
    dt_slam = time.perf_counter() - t0

    gt_dr = m.gt_at(np.asarray(tl_dr.ticks, np.float64))
    gt_s = m.gt_at(ticks_s)
    stats = observability.error_dashboard(
        ticks_s,
        {"odometry": odom[idx][:, :6], "ekf_slam": np.asarray(out["mu"])},
        gt_s,
        path=os.path.join(args.out, "dashboard.png"),
    )
    rep = observability.run_report(
        np.asarray(out["mu"]), gt_s,
        extra={
            "n_landmarks_mapped": int(final.n_active),
            "dr_wall_s": dt_dr,
            "slam_wall_s": dt_slam,
            "slam_realtime_factor": args.duration / dt_slam,
        },
        path=os.path.join(args.out, "report.json"),
    )
    print(json.dumps({"stats": stats, "report": rep}, indent=2))
    print(f"wrote {args.out}/dashboard.png and report.json")


def _pf(args):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from .configs import PFConfig
    from .io import sim
    from .models import particle_filter as pf

    m = sim.simulate(
        sim.MissionSpec(duration_s=args.duration, gps_surface_z=-100.0,
                        gps_std=0.3, dvl_std=0.02, seed=args.seed)
    )
    tl = pf.pf_timeline(m)
    cfg = PFConfig(motion_cov=(1e-4, 1e-4, 0, 0, 0, 1e-6))
    params = pf.make_params(cfg)
    run = jax.jit(
        lambda t: pf.run(t, params, cfg, n_particles=args.particles,
                         scheme=args.scheme)[1]["mean"]
    )
    mean = run(tl)
    jax.block_until_ready(mean)
    t0 = time.perf_counter()
    mean = run(tl)
    jax.block_until_ready(mean)
    dt = time.perf_counter() - t0
    gt = m.gt_at(np.asarray(tl.ticks, np.float64))
    err = np.linalg.norm(np.asarray(mean)[:, :2] - gt[:, :2], axis=-1)
    print(json.dumps({
        "particles": args.particles,
        "ticks": int(tl.num_ticks),
        "wall_s": round(dt, 3),
        "particle_updates_per_sec": round(args.particles * tl.num_ticks / dt, 1),
        "realtime_factor": round(args.duration / dt, 1),
        "xy_err_mean_m": round(float(err.mean()), 3),
    }, indent=2))


def _replay(args):
    """Replay a RECORDED mission log (npz schema, io/logs.py) through the
    EKF-SLAM stack — the rosbag-replay validation workflow of the
    reference (``rosbag_handler.py:7-49``), bags converted via
    ``io.bag_convert``."""
    import jax
    import numpy as np

    from .configs import EKFSlamConfig
    from .io import logs, observability
    from .models import ekf_slam as slam

    streams, meta = logs.load_log(args.log)
    if "odom" not in streams:
        raise SystemExit(f"log has no 'odom' stream (found {sorted(streams)})")
    cfg = dataclasses.replace(
        EKFSlamConfig(), max_landmarks=args.max_landmarks, max_obs=args.max_obs,
        mhl_dist_mbes=args.mhl_dist, q_mbes_diag=(args.q_mbes,) * 3,
        r_diag=(1e-3,) * 6,
    )
    stats = {}
    tl = logs.log_to_timeline(
        streams,
        freq_hz=cfg.system_freq,
        channels=("odom",),
        events={"mbes": cfg.max_obs} if "mbes" in streams else {},
        stats=stats,
    )
    params = slam.make_params(cfg)
    t0 = time.perf_counter()
    final, out = jax.jit(lambda t: slam.run(t, params, cfg))(tl)
    jax.block_until_ready(final.mu)
    wall = time.perf_counter() - t0

    os.makedirs(args.out, exist_ok=True)
    ticks = np.asarray(tl.ticks, np.float64)
    mu = np.asarray(out["mu"])
    extra = {
        "log": args.log,
        "meta": meta,
        "ticks": int(tl.num_ticks),
        "n_landmarks_mapped": int(final.n_active),
        "wall_s": round(wall, 3),
        "realtime_factor": round(float(ticks[-1] - ticks[0]) / wall, 1),
        "event_stats": stats,
    }
    if "gt" in streams:
        base = min(
            s["stamps"][0] for n, s in streams.items() if len(s["stamps"])
        )
        gt_s = streams["gt"]["stamps"] - base
        idx = np.clip(np.searchsorted(gt_s, ticks, side="right") - 1, 0,
                      len(gt_s) - 1)
        gt = np.asarray(streams["gt"]["values"])[idx][:, :6]
        observability.error_dashboard(
            ticks, {"ekf_slam": mu}, gt,
            path=os.path.join(args.out, "dashboard.png"),
        )
        rep = observability.run_report(
            mu, gt, extra=extra, path=os.path.join(args.out, "report.json"),
        )
    else:
        rep = dict(extra, final_pose=[round(float(v), 4) for v in mu[-1]])
        with open(os.path.join(args.out, "report.json"), "w") as f:
            json.dump(rep, f, indent=2)
    print(json.dumps(rep, indent=2, default=str))
    print(f"wrote {args.out}/report.json")


def main(argv=None):
    p = argparse.ArgumentParser(prog="smarc_navigation_tpu.run")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("demo", help="simulate + replay DR/odom/SLAM, write report")
    d.add_argument("--duration", type=float, default=60.0)
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--out", default="/tmp/smarcnav_demo")
    d.set_defaults(fn=_demo)

    r = sub.add_parser("replay", help="replay a recorded mission log (npz)")
    r.add_argument("--log", required=True, help="npz log (io/logs.py schema)")
    r.add_argument("--out", default="/tmp/smarcnav_replay")
    r.add_argument("--max-landmarks", type=int, default=64)
    r.add_argument("--max-obs", type=int, default=8)
    r.add_argument("--mhl-dist", type=float, default=1.0)
    r.add_argument("--q-mbes", type=float, default=0.1)
    r.set_defaults(fn=_replay)

    f = sub.add_parser("pf", help="particle-filter replay benchmark")
    f.add_argument("--duration", type=float, default=60.0)
    f.add_argument("--particles", type=int, default=1_048_576)
    f.add_argument("--seed", type=int, default=0)
    f.add_argument("--scheme", default="residual",
                   choices=("residual", "systematic", "stratified", "multinomial"))
    f.set_defaults(fn=_pf)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()

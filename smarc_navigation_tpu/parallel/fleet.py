"""Monte-Carlo mission fleets: batched filters over the device mesh.

Replaces the reference's serial batch driver (``pf_loop.py:10-46`` —
roslaunch in a shell loop, one mission at a time, overnight) with a vmapped
+ mesh-sharded fleet: every mission is an independent filter replay, the
mission batch shards over the ``mission`` mesh axis, and per-mission
particle banks shard over ``particle``. One jitted program steps the whole
fleet.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..configs import EKFSlamConfig, PFConfig
from ..models import ekf_slam as slam
from ..models import particle_filter as pf
from ..ops.timeline import Timeline
from . import mesh as mesh_lib


class FleetState(NamedTuple):
    slam: slam.SlamState       # batched (B, ...)
    pf: pf.PFState             # batched (B, N, ...)


def init_fleet(
    batch: int,
    n_particles: int,
    slam_cfg: EKFSlamConfig,
    pf_params: pf.PFParams,
    pf_cfg: PFConfig,
    seed: int = 0,
) -> FleetState:
    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    slam0 = slam.init_state(slam_cfg)
    slam_b = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (batch,) + x.shape), slam0
    )
    pf_b = jax.vmap(lambda k: pf.init_state(n_particles, pf_params, key=k))(keys)
    return FleetState(slam=slam_b, pf=pf_b)


def fleet_step(
    slam_cfg: EKFSlamConfig,
    slam_params: slam.SlamParams,
    pf_cfg: PFConfig,
    pf_params: pf.PFParams,
    state: FleetState,
    tick_batch,  # per-mission tick slices, leading axis B
    pf_scheme: str = "residual",
    pf_pmesh=None,
):
    """One fused navigation tick for every mission in the fleet.

    ``pf_scheme="systematic"`` lifts the PF GPS update out of the
    per-mission cond into one fleet-wide batched update
    (``pf.fleet_update_resample``) — semantically identical to the vmapped
    ``pf.step`` (vmap turns the update cond into a select that executes
    both branches anyway) but routable: with ``pf_pmesh`` the resample for
    all missions runs through the explicit-collectives distributed kernel
    over the mesh's particle axis instead of GSPMD gathers (round-3
    verdict #1, fleet leg)."""
    if pf_scheme != "systematic":
        if pf_pmesh is not None:
            raise ValueError(
                "particle-axis sharding (pf_pmesh) requires the systematic "
                "scheme — the distributed resample implements it")

        def one(sl, pfs, tick):
            sl2, sl_out = slam.step(slam_cfg, slam_params, sl, tick)
            pf2, pf_out = pf.step(pf_cfg, pf_params, pfs, tick, pf_scheme)
            return sl2, pf2, {"slam": sl_out, "pf": pf_out}

        sl2, pf2, out = jax.vmap(one)(state.slam, state.pf, tick_batch)
        return FleetState(slam=sl2, pf=pf2), out

    def slam_one(sl, tick):
        return slam.step(slam_cfg, slam_params, sl, tick)

    sl2, sl_out = jax.vmap(slam_one)(state.slam, tick_batch)

    def pred_one(s, tick):
        odom = tick.channels["odom"]
        dt = jnp.maximum(tick.ticks - s.t_prev, 0.0)
        return jax.lax.cond(
            odom.fresh,
            lambda ss: pf.predict(ss, odom.value, dt, pf_params)._replace(
                t_prev=tick.ticks),
            lambda ss: ss,
            s,
        )

    pred = jax.vmap(pred_one)(state.pf, tick_batch)
    gps = tick_batch.channels["gps"]
    diving = tick_batch.channels["diving"]
    do_upd = gps.fresh & (diving.value[:, 0] < 0.5)
    upd = pf.fleet_update_resample(pred, gps.value[:, 0:2], pf_params,
                                   pmesh=pf_pmesh)

    def sel(u, p):
        return jnp.where(do_upd.reshape((-1,) + (1,) * (u.ndim - 1)), u, p)

    pf2 = pf.PFState(particles=sel(upd.particles, pred.particles),
                     key=sel(upd.key, pred.key), t_prev=pred.t_prev)
    mean, cov = jax.vmap(pf.estimate)(pf2.particles)
    out = {"slam": sl_out,
           "pf": {"mean": mean, "cov": cov, "updated": do_upd}}
    return FleetState(slam=sl2, pf=pf2), out


def run_fleet(
    timelines: Timeline,          # batched: every leaf has leading axis B
    slam_cfg: EKFSlamConfig,
    slam_params: slam.SlamParams,
    pf_cfg: PFConfig,
    pf_params: pf.PFParams,
    n_particles: int,
    device_mesh=None,
    seed: int = 0,
    pf_scheme: str | None = None,
):
    """Replay the whole fleet: scan over time of the vmapped fused step.

    ``timelines`` leaves are (B, T, ...); missions shard over the mesh.

    When ``device_mesh`` has a ``particle`` axis wider than 1, per-mission
    particle banks shard across it and the PF GPS update routes through the
    batched explicit-collectives distributed resample (forces the
    systematic scheme — see ``fleet_step``); otherwise ``pf_scheme``
    defaults to the reference's residual sampler (``auv_pf.py:169-198``).
    """
    B = timelines.ticks.shape[0]
    if pf_scheme is None:
        particle_sharded = (device_mesh is not None
                            and device_mesh.shape[mesh_lib.PARTICLE_AXIS] > 1)
        pf_scheme = "systematic" if particle_sharded else "residual"
    pf_pmesh = None
    if (device_mesh is not None
            and device_mesh.shape[mesh_lib.PARTICLE_AXIS] > 1):
        pf_pmesh = device_mesh
    state0 = init_fleet(B, n_particles, slam_cfg, pf_params, pf_cfg, seed)

    if device_mesh is not None:
        state0 = FleetState(
            slam=mesh_lib.shard_missions(state0.slam, device_mesh),
            pf=pf.PFState(
                # (B, 6, N): missions x state-rows x particles
                particles=jax.device_put(
                    state0.pf.particles,
                    mesh_lib.mission_particle_sharding(device_mesh, 3, particle_axis=2),
                ),
                key=jax.device_put(
                    state0.pf.key, mesh_lib.mission_sharding(device_mesh, 2)
                ),
                t_prev=jax.device_put(
                    state0.pf.t_prev, mesh_lib.mission_sharding(device_mesh, 1)
                ),
            ),
        )
        timelines = mesh_lib.shard_missions(timelines, device_mesh)

    # time-major for the scan: (B, T, ...) -> (T, B, ...)
    xs = jax.tree_util.tree_map(lambda x: jnp.swapaxes(x, 0, 1), timelines)

    def body(state, tick_batch):
        return fleet_step(slam_cfg, slam_params, pf_cfg, pf_params, state,
                          tick_batch, pf_scheme=pf_scheme, pf_pmesh=pf_pmesh)

    final, out = jax.lax.scan(body, state0, xs)
    return final, out


def batch_timelines(timelines: list) -> Timeline:
    """Stack per-mission Timelines (same shapes) into one batched Timeline.

    Numpy-leaved timelines (the builders' output) are stacked on host and
    shipped with ONE ``jax.device_put`` per batched leaf instead of one
    small transfer per mission and leaf. Any device-leaved input keeps the
    whole stack on device."""
    if all(isinstance(x, np.ndarray)
           for t in timelines for x in jax.tree_util.tree_leaves(t)):
        batched = jax.tree_util.tree_map(
            lambda *xs: np.stack(xs, axis=0), *timelines)
        return jax.device_put(batched)
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs, axis=0), *timelines)


def run_combined(
    tl_slam: Timeline,            # batched (B=1) SLAM timeline
    tl_pf: Timeline,              # single-mission PF timeline
    slam_params: slam.SlamParams,
    slam_cfg: EKFSlamConfig,
    pf_params: pf.PFParams,
    pf_cfg: PFConfig,
    n_particles: int,
    key=None,
):
    """The BASELINE.json north-star workload: ONE full mission replayed
    through BOTH estimators — the MCL bank through ``particle_filter.run``
    (systematic resampling) and the EKF-SLAM filter through
    ``ekf_slam.run_fleet`` at B=1. Returns one scalar that depends on both
    outputs, so timing it forces both replays."""
    final_pf, out_pf = pf.run(
        tl_pf, pf_params, pf_cfg, n_particles=n_particles, key=key,
        scheme="systematic",
    )
    final_s, _out_s = slam.run_fleet(tl_slam, slam_params, slam_cfg)
    return (jnp.sum(out_pf["mean"])
            + jnp.sum(final_s.mu[:, 0:6])
            + jnp.sum(final_s.n_active))


def run_raycast_fleet(
    gt_tracks: jnp.ndarray,      # (B, T, 6) per-mission vehicle trajectories
    landmark_sets: jnp.ndarray,  # (B, L, 3) per-mission true rock fields
    lm_masks: jnp.ndarray,       # (B, L)
    slam_cfg: EKFSlamConfig,
    slam_params: slam.SlamParams,
    mbes_spec=None,
    device_mesh=None,
):
    """Fully closed-loop Monte-Carlo fleet: per tick and per mission, render
    an MBES ping against the mission's rock field (``ops.raycast``), extract
    detections (``ops.sonar``), and run the SLAM update — everything inside
    one jitted scan, no host in the loop. This is the BASELINE.json
    "batched missions with simulated MBES ray-cast" configuration.

    ``device_mesh``: missions shard over the mesh's ``mission`` axis with
    one ``shard_map`` around the whole fleet scan (independent missions, no
    collectives).

    Returns (final SlamStates (B,...), per-tick (mu (B,T,6), n_active (B,T))).
    """
    from ..ops import raycast

    spec = raycast.MBESSpec() if mbes_spec is None else mbes_spec

    if device_mesh is not None:
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        M = device_mesh.shape[mesh_lib.MISSION_AXIS]
        if gt_tracks.shape[0] % M:
            raise ValueError(
                f"fleet size {gt_tracks.shape[0]} not divisible by "
                f"mission axis {M}")

        def local(gt, lms, lmm, prm):
            return run_raycast_fleet(gt, lms, lmm, slam_cfg, prm, mbes_spec=spec)

        fn = shard_map(
            local, mesh=device_mesh,
            in_specs=(P(mesh_lib.MISSION_AXIS),) * 3 + (P(),),
            out_specs=(P(mesh_lib.MISSION_AXIS), P(mesh_lib.MISSION_AXIS)),
            check_vma=False,
        )
        return fn(gt_tracks, landmark_sets, lm_masks, slam_params)

    def mission(gt_track, lms, lmm):
        def step_fn(state, pose):
            pts, mask = raycast.ping_detections(
                pose, lms, lmm, spec, max_detections=slam_cfg.max_obs
            )
            pred = slam.predict(state, pose, slam_params)
            st, _ = slam.data_associate_update(
                pred, pts, mask, slam_params, slam_cfg, slam.MBES
            )
            return st, (st.mu[0:6], st.n_active)

        return jax.lax.scan(step_fn, slam.init_state(slam_cfg), gt_track)

    return jax.vmap(mission)(gt_tracks, landmark_sets, lm_masks)

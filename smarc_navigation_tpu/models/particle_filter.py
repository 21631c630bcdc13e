"""GPS-weighted Monte-Carlo localization (particle filter).

JAX rebuild of ``auv_particle_filter`` (SURVEY.md §2.1, call stack §3.4).
The reference keeps 50 ``Particle`` python objects and loops over them per
callback (``auv_pf.py:213-216``); here the bank is one (6, N) array —
struct-of-arrays, state components in rows, particles contiguous along the
last axis — the models are fused elementwise row math, and resampling is an
on-device inverse-CDF. The same code runs 50 particles or 10 million, and
shards over a device mesh (``parallel.fleet``). Noise is ``jax.random``
threefry; with ``jax_threefry_partitionable`` (the JAX default) the draws
do not depend on how the bank is sharded.

Semantics preserved:

* motion (``auv_particle.py:38-70``): integrate odometry yaw rate with
  per-particle process noise, read roll/pitch (and depth) absolutely from
  odometry, advance x/y by R(rpy)·v·dt + noise.
* weighting (``auv_particle.py:100-106``): w = N(gps_xy; map-frame particle
  xy, meas_std²·I₂) — computed in log-space then exponentiated with the
  reference's 1e-200 floor (``auv_pf.py:163-166``).
* resampling (``auv_pf.py:169-198``): residual resampling by default, then
  per-particle jitter with the resampling noise covariance. The reference's
  lost/dupes slot-reassignment dance produces the same ancestor multiset as
  a plain gather by ancestor index (only the slot order differs).
* outputs (``auv_pf.py:218-260``): mean pose with yaw wrapping, 3×3 sample
  covariance of position.
* dive gating (``auv_pf.py:122-133``): GPS updates are skipped while diving.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..configs import PFConfig
from ..ops import resampling
from ..ops.timeline import Timeline, build_timeline
from ..utils.geometry import rotmat_from_rpy, rpy_from_quat, wrap_angle


class PFParams(NamedTuple):
    init_cov: jnp.ndarray      # (6,)
    motion_cov: jnp.ndarray    # (6,)
    res_noise_cov: jnp.ndarray # (6,)
    meas_var: jnp.ndarray      # scalar, meas_std²
    # map <- odom transform (the PF estimates in odom, weights in map frame)
    r_m2o: jnp.ndarray         # (3,3)
    t_m2o: jnp.ndarray         # (3,)


class PFState(NamedTuple):
    particles: jnp.ndarray     # (6, N) — rows x,y,z,roll,pitch,yaw
    key: jnp.ndarray
    t_prev: jnp.ndarray


def make_params(
    cfg: PFConfig = PFConfig(),
    r_m2o: np.ndarray | None = None,
    t_m2o: np.ndarray | None = None,
    dtype=jnp.float32,
) -> PFParams:
    return PFParams(
        init_cov=jnp.asarray(cfg.init_cov, dtype),
        motion_cov=jnp.asarray(cfg.motion_cov, dtype),
        res_noise_cov=jnp.asarray(cfg.res_noise_cov, dtype),
        meas_var=jnp.asarray(cfg.measurement_std**2, dtype),
        r_m2o=jnp.asarray(np.eye(3) if r_m2o is None else r_m2o, dtype),
        t_m2o=jnp.asarray(np.zeros(3) if t_m2o is None else t_m2o, dtype),
    )


def init_state(
    n_particles: int,
    params: PFParams,
    key=None,
    mu0=None,
    dtype=jnp.float32,
) -> PFState:
    key = jax.random.PRNGKey(0) if key is None else key
    key, sub = jax.random.split(key)
    base = jnp.zeros(6, dtype) if mu0 is None else jnp.asarray(mu0, dtype)
    noise = jax.random.normal(sub, (6, n_particles), dtype) * jnp.sqrt(
        params.init_cov
    )[:, None]
    return PFState(
        particles=base[:, None] + noise,
        key=key,
        t_prev=jnp.asarray(0.0, dtype),
    )


# ---------------------------------------------------------------------------
# models (single particle; vmapped)
# ---------------------------------------------------------------------------

def motion_model(p: jnp.ndarray, odom: jnp.ndarray, dt, noise: jnp.ndarray) -> jnp.ndarray:
    """odom = [x,y,z, quat4, v3, w3] (13,). One particle step."""
    quat = odom[3:7]
    v = odom[7:10]
    wz = odom[12]

    rot = p[3:6] + jnp.stack([0.0 * wz, 0.0 * wz, wz]) * dt + noise[3:6]
    abs_rpy = rpy_from_quat(quat)
    rpy = jnp.stack([abs_rpy[0], abs_rpy[1], wrap_angle(rot[2])])

    step = rotmat_from_rpy(rpy) @ (v * dt) + noise[0:3]
    x = p[0] + step[0]
    y = p[1] + step[1]
    z = odom[2]  # depth read directly
    return jnp.stack([x, y, z, rpy[0], rpy[1], rpy[2]])


def log_weight(p: jnp.ndarray, gps_map_xy: jnp.ndarray, params: PFParams) -> jnp.ndarray:
    """log N(gps; particle position in map frame, meas_var·I₂)."""
    pos_map = params.r_m2o @ p[0:3] + params.t_m2o
    d = gps_map_xy - pos_map[0:2]
    return -0.5 * jnp.sum(d * d) / params.meas_var - jnp.log(
        2 * jnp.pi * params.meas_var
    )


# ---------------------------------------------------------------------------
# filter steps
# ---------------------------------------------------------------------------

def motion_model_batch(
    parts: jnp.ndarray, odom: jnp.ndarray, dt, noise: jnp.ndarray
) -> jnp.ndarray:
    """Vectorized motion step over the whole bank.

    Same math as ``motion_model`` but in (6, N) struct-of-arrays form:
    pure fused elementwise row math on contiguous (N,) vectors, instead of
    a vmapped per-particle 3×3 matvec that materializes an (N, 3, 3)
    rotation tensor."""
    quat = odom[3:7]
    v = odom[7:10] * dt
    wz = odom[12]
    abs_rpy = rpy_from_quat(quat)

    yaw = wrap_angle(parts[5] + wz * dt + noise[5])
    # reference reads roll/pitch absolutely (their noise components are
    # overwritten before use, i.e. discarded); scalars cos/sin'd once
    roll = jnp.broadcast_to(abs_rpy[0], yaw.shape)
    pitch = jnp.broadcast_to(abs_rpy[1], yaw.shape)

    cr, sr = jnp.cos(abs_rpy[0]), jnp.sin(abs_rpy[0])
    cp, sp = jnp.cos(abs_rpy[1]), jnp.sin(abs_rpy[1])
    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    # rows of R = Rz Ry Rx applied to v, expanded elementwise
    step_x = (cy * cp) * v[0] + (cy * sp * sr - sy * cr) * v[1] + (cy * sp * cr + sy * sr) * v[2]
    step_y = (sy * cp) * v[0] + (sy * sp * sr + cy * cr) * v[1] + (sy * sp * cr - cy * sr) * v[2]

    x = parts[0] + step_x + noise[0]
    y = parts[1] + step_y + noise[1]
    z = jnp.broadcast_to(odom[2], yaw.shape)
    return jnp.stack([x, y, z, roll, pitch, yaw], axis=0)


def predict(state: PFState, odom: jnp.ndarray, dt, params: PFParams) -> PFState:
    key, sub = jax.random.split(state.key)
    n = state.particles.shape[1]
    # only x/y/yaw noise is ever consumed (z is substituted, roll/pitch are
    # absolute — the reference draws 6 and discards 3), so draw only 3 rows
    sd = jnp.sqrt(params.motion_cov)
    n3 = jax.random.normal(sub, (3, n), state.particles.dtype)
    noise = jnp.zeros((6, n), state.particles.dtype)
    noise = noise.at[0].set(n3[0] * sd[0])
    noise = noise.at[1].set(n3[1] * sd[1])
    noise = noise.at[5].set(n3[2] * sd[5])
    parts = motion_model_batch(state.particles, odom, dt, noise)
    return PFState(particles=parts, key=key, t_prev=state.t_prev)


def _gps_weights(particles: jnp.ndarray, gps_map_xy: jnp.ndarray,
                 params: PFParams) -> jnp.ndarray:
    """Normalized GPS-likelihood weights of a (6, N) bank
    (``auv_pf.py:135-166``).

    Fault tolerance: a non-finite particle carries no likelihood — it gets
    zero weight and is culled by the resample instead of poisoning the
    whole bank through the normalization (NaNs otherwise wash through to
    garbage ancestor indices).

    Layout-invariant normalization (round-4 finding): with jnp.sum /
    logsumexp here, GSPMD legally rewrites the reduction into local-reduce
    + all-reduce under a pmesh — even across an explicit replication
    constraint — and a one-ulp weight difference flips an ancestor at a
    stratum boundary (~0.02% of columns per update at 2^14, cascading
    through later CDFs). The order-pinned halving-tree normalization makes
    the weights, hence the ancestors, hence the whole update bit-identical
    between sharded and unsharded programs (tests/test_pf_pmesh.py asserts
    it along a full mission)."""
    # batched log-weights: (3,3) @ (3,N) + fused row math
    pos_map = params.r_m2o @ particles[0:3] + params.t_m2o[:, None]
    dx = gps_map_xy[0] - pos_map[0]
    dy = gps_map_xy[1] - pos_map[1]
    logw = -0.5 * (dx * dx + dy * dy) / params.meas_var - jnp.log(
        2 * jnp.pi * params.meas_var
    )
    logw = jnp.where(jnp.isfinite(logw), logw, -jnp.inf)
    return resampling.normalize_weights_det(logw)


def fleet_update_resample(
    states: PFState,          # batched: particles (B, 6, N), key (B, 2)
    gps_map_xy: jnp.ndarray,  # (B, 2)
    params: PFParams,
    pmesh=None,
) -> PFState:
    """Batched ``update_resample`` (systematic scheme) for a mission fleet.

    With ``pmesh`` the resample for ALL missions runs through ONE shard_map
    over (mission, particle) — the explicit-collectives distributed kernel
    (``resample_dist.systematic_resample_gather_dist_batched``) — instead
    of per-mission GSPMD gathers; without it, the vmapped single-device
    sampler. Both derive ancestors from the same blocked-CDF summation
    tree, so per-mission results are bit-identical across the two routes
    (and to ``update_resample`` itself) under equal keys."""
    keys3 = jax.vmap(lambda k: jax.random.split(k, 3))(states.key)  # (B,3,2)
    key, k_res, k_noise = keys3[:, 0], keys3[:, 1], keys3[:, 2]
    w = jax.vmap(lambda p, g: _gps_weights(p, g, params))(
        states.particles, gps_map_xy)
    use_dist = False
    if pmesh is not None:
        from ..parallel.mesh import PARTICLE_AXIS

        # the blocked-CDF shard body needs CDF_BLOCK-tiled shards; banks too
        # small to tile keep the vmapped sampler (same ancestors — GSPMD's
        # gather is cheap at those sizes)
        ns = states.particles.shape[2] // pmesh.shape[PARTICLE_AXIS]
        use_dist = ns % resampling.CDF_BLOCK == 0
    if use_dist:
        from ..parallel import resample_dist

        parts = resample_dist.systematic_resample_gather_dist_batched(
            states.particles, w, k_res, pmesh)
    else:
        parts = jax.vmap(
            lambda p, wi, k: p[:, resampling.systematic_resample(k, wi)]
        )(states.particles, w, k_res)
    sd = jnp.sqrt(params.res_noise_cov)
    noise = jax.vmap(
        lambda k, p: jax.random.normal(k, p.shape, p.dtype) * sd[:, None]
    )(k_noise, parts)
    return PFState(particles=parts + noise, key=key, t_prev=states.t_prev)


def update_resample(
    state: PFState,
    gps_map_xy: jnp.ndarray,
    params: PFParams,
    scheme: str = "residual",
    pmesh=None,
) -> PFState:
    """GPS weight update + resample + jitter (``auv_pf.py:135-198``).

    ``pmesh``: a mesh with a ``particle`` axis routes the systematic
    resample through the explicit-collectives distributed kernel
    (``parallel.resample_dist`` — all-gathered blocked-CDF prefix, ppermute
    halo exchange), for banks sharded across chips. Ancestors are
    bit-identical to the single-device path (dryrun-verified)."""
    key, k_res, k_noise = jax.random.split(state.key, 3)
    with jax.named_scope("pf_weights"):
        w = _gps_weights(state.particles, gps_map_xy, params)

    with jax.named_scope("pf_resample"):
        if pmesh is not None and scheme == "systematic":
            # multi-device bank: distributed resample, explicit collectives
            from ..parallel import resample_dist

            parts = resample_dist.systematic_resample_gather_dist(
                state.particles, w, k_res, pmesh)
        else:
            idx = resampling.SCHEMES[scheme](k_res, w)
            parts = state.particles[:, idx]
    n = parts.shape[1]
    noise = jax.random.normal(k_noise, (6, n), parts.dtype) * jnp.sqrt(
        params.res_noise_cov
    )[:, None]
    return PFState(particles=parts + noise, key=key, t_prev=state.t_prev)


def estimate(particles: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Mean pose (yaw-wrapped circular mean) + 3×3 position sample covariance
    (``auv_pf.py:218-253``; the reference's arithmetic yaw mean of wrapped
    angles is replaced by the circular mean — identical away from the seam,
    correct at it)."""
    mean = jnp.mean(particles, axis=1)
    s = jnp.mean(jnp.sin(particles[5]))
    c = jnp.mean(jnp.cos(particles[5]))
    yaw = jnp.arctan2(s, c)
    mean = mean.at[5].set(yaw)
    d = particles[0:3] - mean[0:3, None]
    cov = (d @ d.T) / particles.shape[1]
    return mean, cov


def step(
    cfg: PFConfig,
    params: PFParams,
    state: PFState,
    tick,
    scheme: str = "residual",
    pmesh=None,
):
    """One PF tick: predict on fresh odometry, GPS update+resample when a
    fresh fix arrives and the vehicle is not diving.

    ``pmesh``: mesh with a ``particle`` axis — the bank is sharded across
    chips and the (systematic) resample runs through the explicit-
    collectives distributed kernel (``parallel.resample_dist``) instead of
    GSPMD gathers; everything else shards elementwise.
    """
    odom = tick.channels["odom"]     # 13-dim [pos3, quat4, v3, w3]
    gps = tick.channels["gps"]       # 2-dim map-frame fix
    diving = tick.channels["diving"] # 1-dim flag

    dt = jnp.maximum(tick.ticks - state.t_prev, 0.0)

    # named scopes label the legs in a profiler trace (bench.py --trace)
    with jax.named_scope("pf_predict"):
        pred = jax.lax.cond(
            odom.fresh,
            lambda s: predict(s, odom.value, dt, params)._replace(t_prev=tick.ticks),
            lambda s: s,
            state,
        )

    # cond (not where): resampling gathers the whole bank — at 10^6
    # particles it must only run on the (rare) GPS ticks
    do_update = gps.fresh & (diving.value[0] < 0.5)
    with jax.named_scope("pf_update_resample"):
        new_state = jax.lax.cond(
            do_update,
            lambda s: update_resample(
                s, gps.value[0:2], params, scheme, pmesh=pmesh),
            lambda s: s,
            pred,
        )

    with jax.named_scope("pf_moments"):
        mean, cov = estimate(new_state.particles)
    out = {"mean": mean, "cov": cov, "updated": do_update}
    return new_state, out


def run(
    timeline: Timeline,
    params: PFParams,
    cfg: PFConfig = PFConfig(),
    n_particles: int | None = None,
    key=None,
    scheme: str = "residual",
    pmesh=None,
):
    """Full-mission PF replay: one ``lax.scan`` of ``step`` over the
    timeline. Returns (final PFState, per-tick outputs: mean (T, 6),
    cov (T, 3, 3), updated (T,)).

    ``pmesh``: a mesh with a ``particle`` axis shards the bank across
    devices. Predict and weights shard elementwise through GSPMD; the
    systematic resample runs through the explicit-collectives distributed
    resample of ``parallel.resample_dist``."""
    n = cfg.particle_count if n_particles is None else n_particles
    s0 = init_state(n, params, key)
    if pmesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..parallel.mesh import PARTICLE_AXIS

        s0 = s0._replace(particles=jax.device_put(
            s0.particles, NamedSharding(pmesh, P(None, PARTICLE_AXIS))))

    def body(state, tick):
        return step(cfg, params, state, tick, scheme, pmesh=pmesh)

    return jax.lax.scan(body, s0, timeline)


def pf_timeline(mission, freq_hz: float = 10.0) -> Timeline:
    """PF timeline from a simulated mission: odometry (ground-truth-derived
    13-dim), GPS fixes, diving flag."""
    from ..utils.geometry import quat_from_rpy_np

    s = mission.streams
    # odom channel from GT at the odom rate (stands in for the DR output)
    t_odom = np.arange(0.0, mission.spec.duration_s, 0.1)
    gt = mission.gt_at(t_odom)
    quat = quat_from_rpy_np(gt[:, 3:6])
    k = np.clip((t_odom * mission.spec.sim_hz).astype(int), 0, len(mission.t) - 1)
    odom13 = np.concatenate(
        [gt[:, 0:3], quat, mission.vel_body[k], mission.gyro[k]], axis=1
    )
    dive = (gt[:, 2] < mission.spec.gps_surface_z).astype(np.float32)[:, None]
    return build_timeline(
        t0=0.0,
        t1=mission.spec.duration_s,
        freq_hz=freq_hz,
        channels={
            "odom": (t_odom, odom13),
            "gps": (s["gps"]["stamps"], s["gps"]["values"]),
            "diving": (t_odom, dive),
        },
    )

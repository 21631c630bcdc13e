"""15-state EKF — the ``robot_localization`` dual-EKF equivalent.

The reference's SAM stack runs two instances of robot_localization's
``ekf_localization_node`` (15-state: position, orientation, linear velocity,
angular velocity, linear acceleration) configured purely through YAML/launch
(``sam_dead_reckoning/launch/dual_ekf_test.launch:100-230``,
``params/ekf_sam.yaml``): a *local* filter fusing depth pose + DVL twist +
SBG yaw/yaw-rate + STIM roll/pitch/rates with a thrust-derived control
input, and a *global* filter adding GPS x/y. This module is that estimator
family rebuilt for XLA:

* the omega-kinematics transition runs as a pure function and its 15×15
  Jacobian comes from ``jax.jacfwd`` (robot_localization hand-derives it),
* every sensor is a boolean 15-mask + noise diagonal (the YAML ``*_config``
  matrices) applied as a masked identity measurement update — one fused
  update per sensor channel per tick, no callback queues,
* the control term reproduces robot_localization's acceleration shaping:
  accel = gain·(cmd_vel − v) clamped to the acceleration limits
  (``use_control``/``acceleration_limits`` block of the launch file),
* both filters of the dual pair advance inside the same scanned tick.

State layout (robot_localization order): [x y z, roll pitch yaw, vx vy vz,
vroll vpitch vyaw, ax ay az]; velocities body-frame, position world-frame.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.timeline import Timeline, build_timeline
from ..utils.geometry import rotmat_from_rpy, wrap_angle
from ..utils.linalg import spd_solve, symmetrize

STATE_DIM = 15
POS, ATT, VEL, RATE, ACC = slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 12), slice(12, 15)
_ANGLE_IDX = np.array([3, 4, 5])


@dataclasses.dataclass(frozen=True)
class SensorSpec15:
    """One fused input: which state components it measures + its noise."""

    channel: str
    mask: Tuple[bool, ...]        # 15 bools (the YAML *_config matrix)
    noise_diag: Tuple[float, ...]  # 15-wide; only masked entries used
    timeout_s: float = 0.1        # sensor_timeout (launch :104)


# ---------------------------------------------------------------------------
# the reference's dual-filter wiring, transcribed from
# sam_dead_reckoning/launch/dual_ekf_test.launch + params/ekf_sam.yaml
# ---------------------------------------------------------------------------
#
# Sensor noise: robot_localization reads measurement covariances from the
# incoming messages, stamped by the conditioning scripts. press_to_depth.py
# :25 stamps pose z variance 0.1; the DVL/SBG/STIM drivers (dvl_twist.py,
# acc_model.py are absent from the reference repo) stamp driver-level
# covariances — 0.01 stands in for those.
LOCAL_SENSORS = (
    SensorSpec15(  # pose0 depth: z only (launch :131-137)
        "depth", (False,) * 2 + (True,) + (False,) * 12, (0.0,) * 2 + (0.1,) + (0.0,) * 12
    ),
    SensorSpec15(  # twist0 DVL: vx, vy (launch :153-160)
        "dvl",
        (False,) * 6 + (True, True, False) + (False,) * 6,
        (0.0,) * 6 + (0.01, 0.01, 0.0) + (0.0,) * 6,
    ),
    SensorSpec15(  # odom1 GPS: x, y — yes, in the LOCAL filter too (:163-171)
        "gps", (True, True) + (False,) * 13, (1.0, 1.0) + (0.0,) * 13
    ),
    SensorSpec15(  # imu0 SBG: yaw + yaw rate (launch :174-181)
        "sbg",
        (False,) * 5 + (True,) + (False,) * 5 + (True,) + (False,) * 3,
        (0.0,) * 5 + (0.01,) + (0.0,) * 5 + (0.01,) + (0.0,) * 3,
    ),
    SensorSpec15(  # imu1 STIM: roll, pitch + roll/pitch rates (launch :190-197)
        "stim",
        (False,) * 3 + (True, True, False) + (False,) * 3 + (True, True, False) + (False,) * 3,
        (0.0,) * 3 + (0.01, 0.01, 0.0) + (0.0,) * 3 + (0.01, 0.01, 0.0) + (0.0,) * 3,
    ),
)

# ekf_loc_global wiring (dual_ekf_test.launch:242-345): odom0 GPS (x, y),
# pose0 depth (z), twist0 DVL (vx, vy), imu0 SBG with FULL orientation +
# rates (roll, pitch, yaw, vroll, vpitch, vyaw — :316-323); imu1 STIM is
# configured all-false there (:330-336), i.e. unused.
GLOBAL_SENSORS = (
    SensorSpec15(
        "gps", (True, True) + (False,) * 13, (1.0, 1.0) + (0.0,) * 13
    ),
    SensorSpec15(
        "depth", (False,) * 2 + (True,) + (False,) * 12, (0.0,) * 2 + (0.1,) + (0.0,) * 12
    ),
    SensorSpec15(
        "dvl",
        (False,) * 6 + (True, True, False) + (False,) * 6,
        (0.0,) * 6 + (0.01, 0.01, 0.0) + (0.0,) * 6,
    ),
    SensorSpec15(
        "sbg",
        (False,) * 3 + (True,) * 3 + (False,) * 3 + (True,) * 3 + (False,) * 3,
        (0.0,) * 3 + (0.01,) * 3 + (0.0,) * 3 + (0.01,) * 3 + (0.0,) * 3,
    ),
)

# process/initial covariances, params/ekf_sam.yaml (x y z r p y vx vy vz
# vr vp vy ax ay az): the GLOBAL filter's own tuning differs from the
# local one in x, y (1e-3/1e-2 -> 1.0) and vy (0.01 -> 0.5) — yaml :3-17
# vs :38-52
LOCAL_PROCESS_NOISE_DIAG = (
    1e-3, 1e-2, 1e-2, 0.3, 0.3, 0.01, 0.5, 0.01, 0.1, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3
)
LOCAL_INITIAL_COV_DIAG = (
    1e-3, 1e-3, 1e-3, 1.0, 1.0, 1e-1, 1e-3, 1e-3, 1e-3, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0
)
GLOBAL_PROCESS_NOISE_DIAG = (
    1.0, 1.0, 1e-3, 0.3, 0.3, 0.01, 0.5, 0.5, 0.1, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3
)
GLOBAL_INITIAL_COV_DIAG = (
    1.0, 1.0, 1e-9, 1.0, 1.0, 1e-9, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0
)


@dataclasses.dataclass(frozen=True)
class Ekf15Config:
    frequency: float = 100.0                      # launch :103
    sensors: Tuple[SensorSpec15, ...] = LOCAL_SENSORS
    process_noise_diag: Tuple[float, ...] = LOCAL_PROCESS_NOISE_DIAG
    initial_cov_diag: Tuple[float, ...] = LOCAL_INITIAL_COV_DIAG
    # control shaping (launch :212-227: use_control, control_config x/y,
    # acceleration/deceleration limits and gains all 0.1 on x, y)
    use_control: bool = True
    control_gains: Tuple[float, ...] = (0.1, 0.1, 0.0)
    control_limits: Tuple[float, ...] = (0.1, 0.1, 0.0)


def global_config(frequency: float = 100.0) -> Ekf15Config:
    """The ekf_loc_global instance: GPS + depth + DVL + full-SBG sensor set
    with the global yaml tuning (map-frame world)."""
    return Ekf15Config(
        frequency=frequency,
        sensors=GLOBAL_SENSORS,
        process_noise_diag=GLOBAL_PROCESS_NOISE_DIAG,
        initial_cov_diag=GLOBAL_INITIAL_COV_DIAG,
    )


class Ekf15State(NamedTuple):
    x: jnp.ndarray      # (15,)
    P: jnp.ndarray      # (15,15)
    t_prev: jnp.ndarray


def init_state(cfg: Ekf15Config, x0=None, dtype=jnp.float32) -> Ekf15State:
    x = jnp.zeros(STATE_DIM, dtype) if x0 is None else jnp.asarray(x0, dtype)
    return Ekf15State(
        x=x,
        P=jnp.diag(jnp.asarray(cfg.initial_cov_diag, dtype)),
        t_prev=jnp.asarray(0.0, dtype),
    )


# ---------------------------------------------------------------------------
# transition
# ---------------------------------------------------------------------------

def _euler_rate_matrix(rpy: jnp.ndarray) -> jnp.ndarray:
    """Body rates -> Euler angle rates."""
    r, p = rpy[0], rpy[1]
    sr, cr = jnp.sin(r), jnp.cos(r)
    cp = jnp.cos(p)
    tp = jnp.tan(p)
    return jnp.asarray(
        [
            [1.0, sr * tp, cr * tp],
            [0.0, cr, -sr],
            [0.0, sr / cp, cr / cp],
        ]
    )


def transition(x: jnp.ndarray, dt, accel_cmd: jnp.ndarray | None = None) -> jnp.ndarray:
    """Discrete omega-kinematics step (robot_localization's motion model)."""
    pos, rpy, v, w, a = x[POS], x[ATT], x[VEL], x[RATE], x[ACC]
    if accel_cmd is not None:
        a = a + accel_cmd  # control-shaped acceleration adds to the state term
    R = rotmat_from_rpy(rpy)
    pos_n = pos + R @ (v * dt + 0.5 * a * dt * dt)
    rpy_n = wrap_angle(rpy + _euler_rate_matrix(rpy) @ (w * dt))
    v_n = v + a * dt
    return jnp.concatenate([pos_n, rpy_n, v_n, w, x[ACC]])


def control_accel(cfg: Ekf15Config, v: jnp.ndarray, cmd_vel: jnp.ndarray) -> jnp.ndarray:
    """Control-to-acceleration shaping: gain·(cmd − v) clamped to limits."""
    g = jnp.asarray(cfg.control_gains, v.dtype)
    lim = jnp.asarray(cfg.control_limits, v.dtype)
    return jnp.clip(g * (cmd_vel - v[:3]), -lim, lim)


def predict(state: Ekf15State, cfg: Ekf15Config, dt, accel_cmd=None) -> Ekf15State:
    f = lambda x: transition(x, dt, accel_cmd)
    x_n = f(state.x)
    F = jax.jacfwd(f)(state.x)
    Q = jnp.diag(jnp.asarray(cfg.process_noise_diag, state.x.dtype)) * dt
    P_n = symmetrize(F @ state.P @ F.T + Q)
    return Ekf15State(x=x_n, P=P_n, t_prev=state.t_prev)


# ---------------------------------------------------------------------------
# masked identity update
# ---------------------------------------------------------------------------

def update(
    state: Ekf15State,
    z15: jnp.ndarray,       # (15,) measurement padded to full state layout
    spec_mask: jnp.ndarray,  # (15,) bool
    noise_diag: jnp.ndarray,
    apply: jnp.ndarray,      # scalar bool: sensor fresh & within timeout
) -> Ekf15State:
    """EKF update through a masked identity H. Unmeasured components get a
    huge noise instead of a shape change (static shapes; their Kalman gain
    is ~0 and the `apply` flag gates the whole update anyway)."""
    big = jnp.asarray(1e12, state.x.dtype)
    r = jnp.where(spec_mask, jnp.maximum(noise_diag, 1e-9), big)
    nu = z15 - state.x
    nu = nu.at[_ANGLE_IDX].set(wrap_angle(nu[_ANGLE_IDX]))
    nu = jnp.where(spec_mask, nu, 0.0)

    S = state.P + jnp.diag(r)
    K = spd_solve(S, state.P).T            # P S⁻¹ (H = I)
    x_n = state.x + K @ nu
    x_n = x_n.at[_ANGLE_IDX].set(wrap_angle(x_n[_ANGLE_IDX]))
    P_n = symmetrize((jnp.eye(STATE_DIM, dtype=state.x.dtype) - K) @ state.P)

    return Ekf15State(
        x=jnp.where(apply, x_n, state.x),
        P=jnp.where(apply, P_n, state.P),
        t_prev=state.t_prev,
    )


# ---------------------------------------------------------------------------
# tick + replay (dual pair)
# ---------------------------------------------------------------------------

def step(cfg: Ekf15Config, state: Ekf15State, tick) -> Tuple[Ekf15State, dict]:
    t_now = tick.ticks
    dt = jnp.maximum(t_now - state.t_prev, 0.0)

    accel_cmd = None
    if cfg.use_control and "cmd_vel" in tick.channels:
        cmd = tick.channels["cmd_vel"]
        accel_cmd = jnp.where(
            cmd.valid, control_accel(cfg, state.x[VEL], cmd.value[0:3]), jnp.zeros(3)
        )
    st = predict(state, cfg, dt, accel_cmd)

    for spec in cfg.sensors:
        if spec.channel not in tick.channels:
            # configured input not wired in this mission (e.g. GPS-denied
            # replay without a gps channel) — like a never-publishing topic
            continue
        ch = tick.channels[spec.channel]
        apply = ch.fresh & (ch.age < spec.timeout_s)
        st = update(
            st,
            ch.value[0:STATE_DIM],
            jnp.asarray(spec.mask),
            jnp.asarray(spec.noise_diag, st.x.dtype),
            apply,
        )

    st = st._replace(t_prev=t_now)
    return st, {"x": st.x, "p_diag": jnp.diagonal(st.P)}


def run(timeline: Timeline, cfg: Ekf15Config = Ekf15Config(), state0=None):
    s0 = init_state(cfg) if state0 is None else state0

    def body(state, tick):
        return step(cfg, state, tick)

    return jax.lax.scan(body, s0, timeline)


def map_to_odom_correction(x_global: jnp.ndarray, x_local: jnp.ndarray):
    """The dual-EKF map->odom tf: T_map_odom = T_map_base · T_odom_base⁻¹,
    built from the global filter's map-frame pose and the local filter's
    odom-frame pose — what robot_localization's ekf_loc_global broadcasts
    when ``publish_tf``/``map_odom_tf_ekf`` is on (dual_ekf_test.launch:
    15,27,345; world_frame=map at :251). Accepts leading batch/time axes.

    Returns a ``Transform`` mapping odom-frame points into the map frame.
    """
    from ..utils.geometry import Transform

    t_map_base = Transform(
        rot=rotmat_from_rpy(x_global[..., 3:6]), trans=x_global[..., 0:3]
    )
    t_odom_base = Transform(
        rot=rotmat_from_rpy(x_local[..., 3:6]), trans=x_local[..., 0:3]
    )
    return t_map_base.compose(t_odom_base.inverse())


def run_dual(
    timeline_local: Timeline,
    timeline_global: Timeline,
    cfg_local: Ekf15Config = Ekf15Config(),
    cfg_global: Ekf15Config | None = None,
):
    """The dual-EKF pair (dual_ekf_test.launch:102-345): local filter in
    the odom frame (continuous sensors + GPS odom1), global filter in the
    map frame (GPS + depth + DVL + full SBG) with its own yaml tuning.
    Returns both runs plus the per-tick map->odom correction transforms."""
    if cfg_global is None:
        cfg_global = global_config(frequency=cfg_local.frequency)
    final_l, out_l = run(timeline_local, cfg_local)
    final_g, out_g = run(timeline_global, cfg_global)
    map_odom = map_to_odom_correction(out_g["x"], out_l["x"])
    return (final_l, out_l), (final_g, out_g), map_odom


def ekf15_timeline(mission, cfg: Ekf15Config, include_gps: bool = False) -> Timeline:
    """Build the dual-EKF sensor timeline from a simulated mission: depth,
    DVL, SBG (yaw/yaw-rate), STIM (roll/pitch/rates), cmd_vel, optional GPS,
    each padded into the 15-wide state layout."""
    from ..utils.geometry import rpy_from_quat

    s = mission.streams
    T15 = STATE_DIM

    def pad(vals, idx):
        out = np.zeros((len(vals), T15))
        for k, i in enumerate(idx):
            out[:, i] = vals[:, k]
        return out

    depth = pad(s["depth"]["values"], [2])
    dvl = pad(s["dvl"]["values"][:, 0:2], [6, 7])

    imu_q = s["imu"]["values"][:, 0:4]
    rpy = np.asarray(jax.vmap(rpy_from_quat)(jnp.asarray(imu_q)))
    gyro = s["imu"]["values"][:, 4:7]
    sbg = pad(np.stack([rpy[:, 2], gyro[:, 2]], -1), [5, 11])
    stim = pad(np.concatenate([rpy[:, 0:2], gyro[:, 0:2]], -1), [3, 4, 9, 10])

    # control channel: the launch remaps cmd_vel -> motion_acc (:229), the
    # thrusters' SAM-motion-model output (acc_model.py, absent from the
    # reference repo; the in-repo model is sam_mm.py) with control_config
    # [x, y] (:216-218) — so the control port carries the model's body-
    # plane thrust response on x/y, shaped by gain·(cmd − v) with the 0.1
    # acceleration limits in `control_accel`.
    from . import motion_model

    ctl = s["control"]["values"]
    acc_mm = np.asarray(motion_model.acceleration(jnp.asarray(ctl, jnp.float32)))
    cmd = np.zeros((len(ctl), 3))
    cmd[:, 0:2] = acc_mm[:, 0:2]

    channels = {
        "depth": (s["depth"]["stamps"], depth),
        "dvl": (s["dvl"]["stamps"], dvl),
        "sbg": (s["imu"]["stamps"], sbg),
        "stim": (s["imu"]["stamps"], stim),
        "cmd_vel": (s["control"]["stamps"], cmd),
    }
    if include_gps:
        channels["gps"] = (s["gps"]["stamps"], pad(s["gps"]["values"], [0, 1]))
    return build_timeline(
        t0=0.0, t1=mission.spec.duration_s, freq_hz=cfg.frequency, channels=channels
    )


def run_fleet(batched_timeline, cfg: Ekf15Config = Ekf15Config(), x0=None):
    """Fleet replay: ``run`` vmapped over the missions of a batched timeline
    (leaves (B, T, ...), as from ``fleet.batch_timelines`` of
    ``ekf15_timeline`` outputs). Returns (final Ekf15State with a leading
    mission axis, out) with ``out`` time-major: x (T, B, 15),
    p_diag (T, B, 15)."""
    s0 = init_state(cfg, x0=x0)
    final, out = jax.vmap(lambda tl: run(tl, cfg, s0))(batched_timeline)
    return final, jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, 0, 1), out)


def run_dual_fleet(
    batched_local: Timeline,
    batched_global: Timeline,
    cfg_local: Ekf15Config = Ekf15Config(),
    cfg_global: Ekf15Config | None = None,
):
    """The DUAL-EKF pair (local odom-frame + global map-frame filter with
    the yaml tuning of ``dual_ekf_test.launch:102-345``) at fleet scale:
    ``run_dual`` per mission, batched. Outputs are time-major like
    ``run_fleet``'s; the map->odom corrections are (T, B)."""
    if cfg_global is None:
        cfg_global = global_config(frequency=cfg_local.frequency)
    final_l, out_l = run_fleet(batched_local, cfg_local)
    final_g, out_g = run_fleet(batched_global, cfg_global)
    map_odom = map_to_odom_correction(out_g["x"], out_l["x"])
    return (final_l, out_l), (final_g, out_g), map_odom

"""6-DOF EKF localization against a known landmark map.

JAX rebuild of ``auv_ekf_localization`` (SURVEY.md §2.1): the ROS
timer tick (``src/ekf_localization.cpp:547-624``) becomes a pure step
function folded over the mission timeline with ``lax.scan``.

Semantics preserved from the reference:

* motion update from DVL body velocity + IMU absolute orientation
  (``computeOdom``/``predictMotion``, ``ekf_localization.cpp:360-437``):
  μ̂ = μ + u with u = [R(q_auv)·R_base_dvl·v·Δt, wrap(rpy_imu − μ_rpy)];
  Σ̂ = G Σ Gᵀ + R where G has an identity position block, the analytic
  ∂(R(rpy)·Δbase)/∂rpy coupling block, and *zero* orientation rows —
  orientation is measured absolutely each tick, so its prior is discarded.
  The coupling block is generated by ``jax.jacfwd`` of the same displacement
  function instead of hand-expanded trig (identical values, traced once).

* measurement model h(μ, lm) = R(μ_rpy)ᵀ(lm − μ_pos) with 3×6 Jacobian
  (``predictMeasurement``/``computeH``, ``correspondence_obj.cpp:21-62``) —
  again ``jacfwd`` of h.

* per-measurement greedy maximum-likelihood association with the landmark
  pre-gate heuristic, χ²(3) Mahalanobis outlier rejection, the stone-volume
  offset on detection y/z, and *sequential* updates in measurement order
  (``dataAssociation``/``sequentialUpdate``, ``ekf_localization.cpp:479-545``).
  The inner landmark loop becomes one batched (N_map) Mahalanobis/likelihood
  tensor op + argmax; the measurement loop stays a scan because each update
  changes the state the next association sees (reference behavior).

The whole tick is a pure function of (state, sensor slice) and is vmappable
over mission fleets.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..configs import EKFLocConfig
from ..ops import bezier
from ..ops.timeline import Timeline, build_timeline
from ..utils.geometry import rotmat_from_rpy, rpy_from_quat, wrap_angle
from ..utils.linalg import chi2_quantile, inv_det_small3


class EKFLocParams(NamedTuple):
    """Static (per-mission) parameters."""

    map_pos: jnp.ndarray    # (N, 3) known landmark positions (odom frame)
    map_mask: jnp.ndarray   # (N,) which slots hold real landmarks
    Q: jnp.ndarray          # (3, 3) measurement noise
    R: jnp.ndarray          # (6, 6) motion noise
    lambda_m: jnp.ndarray   # scalar χ²(3) gate
    r_base_dvl: jnp.ndarray  # (3, 3) DVL->base extrinsic rotation


class EKFLocState(NamedTuple):
    mu: jnp.ndarray         # (6,)
    Sigma: jnp.ndarray      # (6, 6)
    t_prev: jnp.ndarray     # scalar


def make_params(
    map_pos: np.ndarray,
    cfg: EKFLocConfig = EKFLocConfig(),
    r_base_dvl: np.ndarray | None = None,
    dtype=jnp.float32,
) -> EKFLocParams:
    n = cfg.max_landmarks
    m = np.zeros((n, 3), dtype=np.float64)
    k = min(len(map_pos), n)
    m[:k] = map_pos[:k]
    mask = np.zeros(n, bool)
    mask[:k] = True
    return EKFLocParams(
        map_pos=jnp.asarray(m, dtype),
        map_mask=jnp.asarray(mask),
        Q=jnp.diag(jnp.asarray(cfg.q_diag, dtype)),
        R=jnp.diag(jnp.asarray(cfg.r_diag, dtype)),
        lambda_m=jnp.asarray(chi2_quantile(cfg.delta_outlier_reject, 3), dtype),
        r_base_dvl=jnp.asarray(
            np.eye(3) if r_base_dvl is None else r_base_dvl, dtype
        ),
    )


def init_state(cfg: EKFLocConfig = EKFLocConfig(), mu0=None, dtype=jnp.float32) -> EKFLocState:
    mu = jnp.zeros(6, dtype) if mu0 is None else jnp.asarray(mu0, dtype)
    return EKFLocState(
        mu=mu,
        Sigma=jnp.diag(jnp.asarray(cfg.sigma0_diag, dtype)),
        t_prev=jnp.asarray(0.0, dtype),
    )


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def meas_model(mu: jnp.ndarray, lm: jnp.ndarray) -> jnp.ndarray:
    """h(μ, lm): landmark position expressed in the base frame."""
    return rotmat_from_rpy(mu[3:6]).T @ (lm - mu[0:3])


def meas_jacobian(mu: jnp.ndarray, lm: jnp.ndarray) -> jnp.ndarray:
    """3×6 ∂h/∂μ — generated from the model (== the analytic expansion at
    ``correspondence_obj.cpp:21-62``; unit-tested against it)."""
    return jax.jacfwd(meas_model, argnums=0)(mu, lm)


def motion_jacobian(rpy: jnp.ndarray, disp_base: jnp.ndarray) -> jnp.ndarray:
    """6×6 G_t: identity position block, ∂(R(rpy)·Δ)/∂rpy coupling, zero
    orientation rows (absolute attitude; ``computeOdom``,
    ``ekf_localization.cpp:393-419``)."""
    J = jax.jacfwd(lambda a: rotmat_from_rpy(a) @ disp_base)(rpy)  # (3,3)
    G = jnp.zeros((6, 6), dtype=rpy.dtype)
    G = G.at[0:3, 0:3].set(jnp.eye(3, dtype=rpy.dtype))
    G = G.at[0:3, 3:6].set(J)
    return G


def predict(
    state: EKFLocState,
    params: EKFLocParams,
    v_dvl: jnp.ndarray,     # (3,) DVL body velocity
    q_auv: jnp.ndarray,     # (4,) absolute orientation (odom frame)
    t_now: jnp.ndarray,
) -> EKFLocState:
    dt = jnp.maximum(t_now - state.t_prev, 0.0)
    disp_base = params.r_base_dvl @ (v_dvl * dt)
    rpy_t = rpy_from_quat(q_auv)
    disp_odom = rotmat_from_rpy(rpy_t) @ disp_base
    u = jnp.concatenate([disp_odom, wrap_angle(rpy_t - state.mu[3:6])])

    mu_hat = state.mu + u
    mu_hat = mu_hat.at[3:6].set(wrap_angle(mu_hat[3:6]))
    G = motion_jacobian(rpy_t, disp_base)
    Sigma_hat = G @ state.Sigma @ G.T + params.R
    return EKFLocState(mu=mu_hat, Sigma=Sigma_hat, t_prev=t_now)


def _landmark_pregate(mu: jnp.ndarray, lm: jnp.ndarray, epsilon: float) -> jnp.ndarray:
    """Reference's landmark narrowing heuristic (``ekf_localization.cpp:508``):
    ε > |(lm_x − μ_x) + (μ_y − lm_y)/tan(wrap(π/2 + ψ))|."""
    t = jnp.tan(wrap_angle(jnp.pi / 2.0 + mu[5]))
    val = (lm[..., 0] - mu[0]) + (mu[1] - lm[..., 1]) / t
    return epsilon > jnp.abs(val)


def update_one(
    mu: jnp.ndarray,
    Sigma: jnp.ndarray,
    z: jnp.ndarray,          # (3,) detection in base frame (offset applied)
    z_valid: jnp.ndarray,
    params: EKFLocParams,
    cfg: EKFLocConfig,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Greedy-ML association + sequential EKF update for one measurement.

    Returns (mu, Sigma, matched_landmark_index or -1).
    """
    # batched correspondence over all map slots. H's position block is -Rᵀ
    # (shared), and its angle block is the shared ∂Rᵀ/∂rpy tensor contracted
    # with each landmark offset — one jacfwd + one einsum instead of N
    # per-slot jacobians (the per-op overhead of N tiny jacfwds dominated
    # the fleet profile).
    Rt = rotmat_from_rpy(mu[3:6]).T                                       # (3,3)
    dRt = jax.jacfwd(lambda a: rotmat_from_rpy(a).T)(mu[3:6])             # (3,3,3)
    diff = params.map_pos - mu[0:3]                                       # (N,3)
    z_hat = diff @ Rt.T                                                   # (N,3)
    H_ang = jnp.einsum("ijk,nj->nik", dRt, diff)                          # (N,3,3)
    H = jnp.concatenate(
        [jnp.broadcast_to(-Rt, (params.map_pos.shape[0], 3, 3)), H_ang], axis=2
    )                                                                     # (N,3,6)
    S = jnp.einsum("nij,jk,nlk->nil", H, Sigma, H) + params.Q             # (N,3,3)
    nu = z[None, :] - z_hat                                               # (N,3)
    S_inv, S_det = inv_det_small3(S)
    d_m = jnp.einsum("ni,nij,nj->n", nu, S_inv, nu)                       # (N,)
    # ψ = det(π·S)^{-1/2} exp(-d/2)  (π·S normalization quirk preserved)
    psi = jnp.exp(-0.5 * d_m) * jax.lax.rsqrt(jnp.pi**3 * jnp.maximum(S_det, 1e-30))

    ok = (
        params.map_mask
        & _landmark_pregate(mu, params.map_pos, cfg.epsilon)
        & (d_m < params.lambda_m)
        & z_valid
    )
    psi_masked = jnp.where(ok, psi, -jnp.inf)
    best = jnp.argmax(psi_masked)
    any_ok = jnp.any(ok)

    Hb, nub = H[best], nu[best]
    K = Sigma @ Hb.T @ S_inv[best]                                         # Σ Hᵀ S⁻¹
    mu_new = mu + K @ nub
    mu_new = mu_new.at[3:6].set(wrap_angle(mu_new[3:6]))
    Sigma_new = (jnp.eye(6, dtype=Sigma.dtype) - K @ Hb) @ Sigma

    mu = jnp.where(any_ok, mu_new, mu)
    Sigma = jnp.where(any_ok, Sigma_new, Sigma)
    matched = jnp.where(any_ok, best, -1)
    return mu, Sigma, matched


def step(
    cfg: EKFLocConfig,
    params: EKFLocParams,
    state: EKFLocState,
    tick,
) -> Tuple[EKFLocState, dict]:
    """One filter tick (``ekfLocalize``, ``ekf_localization.cpp:547-624``)."""
    imu = tick.channels["imu"]
    dvlw = tick.windows["dvl"]
    det = tick.events["mbes_detections"]
    t_now = tick.ticks

    # DVL: synced-latest or Bézier window extrapolation when stale
    newest = dvlw.stamp[-1]
    stale = (t_now - newest) > (0.5 / cfg.system_freq)
    v = jnp.where(
        stale, bezier.bezier_interpolate(dvlw.value, dvlw.stamp, t_now), dvlw.value[-1]
    )

    pred = predict(state, params, v, imu.value[0:4], t_now)

    # stone-volume compensation on raw detections (ekf_localization.cpp:489-492)
    z_all = det.value - jnp.asarray([0.0, cfg.stone_offset, cfg.stone_offset],
                                    dtype=det.value.dtype)

    def da_body(carry, zm):
        mu, Sigma = carry
        z, valid = zm
        mu, Sigma, matched = update_one(mu, Sigma, z, valid, params, cfg)
        return (mu, Sigma), matched

    (mu, Sigma), matches = jax.lax.scan(
        da_body, (pred.mu, pred.Sigma), (z_all, det.mask)
    )

    # gate: without IMU+DVL contact the reference re-broadcasts the last pose
    have_inputs = imu.valid & (dvlw.count > 0)
    new_state = EKFLocState(
        mu=jnp.where(have_inputs, mu, state.mu),
        Sigma=jnp.where(have_inputs, Sigma, state.Sigma),
        t_prev=jnp.where(have_inputs, t_now, state.t_prev),
    )
    out = {
        "mu": new_state.mu,
        "sigma_diag": jnp.diagonal(new_state.Sigma),
        "matches": matches,
        "num_matched": jnp.sum(matches >= 0),
    }
    return new_state, out


def run(
    timeline: Timeline,
    params: EKFLocParams,
    cfg: EKFLocConfig = EKFLocConfig(),
    state0: EKFLocState | None = None,
):
    """Replay a mission -> dict of stacked per-tick outputs."""
    s0 = init_state(cfg) if state0 is None else state0

    def body(state, tick):
        return step(cfg, params, state, tick)

    final, out = jax.lax.scan(body, s0, timeline)
    return final, out


def run_fleet(
    batched_timeline: Timeline,
    params: EKFLocParams,
    cfg: EKFLocConfig = EKFLocConfig(),
):
    """Fleet replay: ``run`` vmapped over the missions of a batched timeline
    (leaves (B, T, ...)). Returns (final state with a leading mission axis,
    out) with ``out`` time-major like ``run``'s scan over the fleet:
    mu (T, B, 6), sigma_diag (T, B, 6), matches (T, B, M),
    num_matched (T, B)."""
    final, out = jax.vmap(lambda tl: run(tl, params, cfg))(batched_timeline)
    return final, jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, 0, 1), out)


def loc_timeline(mission, cfg: EKFLocConfig = EKFLocConfig()) -> Timeline:
    """Timeline for the localization filter from a simulated mission."""
    s = mission.streams
    det = s["mbes_detections"]
    return build_timeline(
        t0=0.0,
        t1=mission.spec.duration_s,
        freq_hz=cfg.system_freq,
        channels={"imu": (s["imu"]["stamps"], s["imu"]["values"])},
        windows={"dvl": (s["dvl"]["stamps"], s["dvl"]["values"], cfg.dvl_window)},
        events={
            "mbes_detections": (det["stamps"], det["values"], det["burst"], cfg.max_obs)
        },
    )

"""Online EKF-SLAM with MBES / FLS landmark detections.

JAX rebuild of ``auv_ekf_slam`` (SURVEY.md §2.1, call stack §3.2).
The reference grows its state vector with every confirmed landmark
(``conservativeResize``, ``ekf_utils.cpp:25-44``); data-dependent shapes
don't exist under XLA, so the state is a fixed-size *padded* bank of
``max_landmarks`` 3-DOF slots with an ``active`` mask — landmark "addition"
is a masked slot activation, and all correspondence math runs batched over
every slot with inactive rows masked out of the assignment.

Semantics preserved from the reference:

* ``predictMotion`` (``ekf_slam_core.cpp:41-121``): consumes *absolute*
  odometry — position becomes an increment u_t against the accumulated odom
  position, attitude is taken absolutely (so the orientation rows of G are
  zero and orientation covariance resets to R each tick); Σ̂ = GΣGᵀ + FᵀRF
  computed in block form (only 6 rows/cols of G differ from identity —
  O(L) instead of the dense O(L²) matmul).

* ``batchDataAssociation`` (``ekf_slam_core.cpp:184-346``): every detection
  back-projects to a new-landmark candidate; a (slots+candidates) ×
  detections Mahalanobis cost table is built from per-slot 9×9 marginals
  (pose + landmark block, ``ekf_utils.cpp:18-23``), χ²-gated to the outlier
  cost 10000, candidate rows carry the fixed ``mh_dist`` diagonal; a global
  optimal assignment picks matches (exact Jonker-Volgenant Hungarian on
  device inside jit; optionally the host scipy path for cross-checks).

* ``sequentialUpdate`` (``ekf_slam_core.cpp:351-371``): matches are applied
  in measurement order; H, S⁻¹ and ν come from the batch stage (computed at
  the pre-update μ̂ — reference behavior) while the 9×9 marginal Σ is
  re-gathered fresh per update; only the pose/landmark blocks of Σ are
  written back.

* sensor models: MBES z = T_base_map·lm (3-D, ``correspondence_obj_mbes.cpp:
  26-44``); FLS pixel measurement z = (400/17)·(‖P_xz(T_fls_map·lm)‖,
  −(T_fls_map·lm)_y) with polar back-projection (``correspondence_obj_fls.cpp:
  25-58``). Jacobians are ``jacfwd`` of these models — identical to the
  reference's hand-expanded chain h₂·R_fls_base·h₁.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..configs import EKFSlamConfig
from ..ops import assignment
from ..ops.timeline import Timeline, build_timeline
from ..utils.geometry import Transform, rotmat_from_rpy, wrap_angle
from ..utils.linalg import chi2_quantile, inv_small


class SlamParams(NamedTuple):
    R: jnp.ndarray            # (6,6) motion noise
    Q_mbes: jnp.ndarray       # (3,3)
    Q_fls: jnp.ndarray        # (2,2)
    lambda_mbes: jnp.ndarray  # χ²(δ,3) gate
    lambda_fls: jnp.ndarray   # χ²(δ,2) gate
    r_fls_base: jnp.ndarray   # (3,3) base->fls rotation
    t_fls_base: jnp.ndarray   # (3,) base->fls translation


class SlamState(NamedTuple):
    mu: jnp.ndarray           # (6 + 3L,)
    Sigma: jnp.ndarray        # (6+3L, 6+3L)
    active: jnp.ndarray       # (L,) bool
    n_active: jnp.ndarray     # int32
    mu_auv_odom: jnp.ndarray  # (3,) accumulated odom position


def make_params(
    cfg: EKFSlamConfig = EKFSlamConfig(),
    tf_base_fls: Transform | None = None,
    dtype=jnp.float32,
) -> SlamParams:
    if tf_base_fls is None:
        tf_base_fls = Transform.identity(dtype)
    tf_fls_base = tf_base_fls.inverse()
    return SlamParams(
        R=jnp.diag(jnp.asarray(cfg.r_diag, dtype)),
        Q_mbes=jnp.diag(jnp.asarray(cfg.q_mbes_diag, dtype)),
        Q_fls=jnp.diag(jnp.asarray(cfg.q_fls_diag, dtype)),
        lambda_mbes=jnp.asarray(chi2_quantile(cfg.delta_outlier_reject, 3), dtype),
        lambda_fls=jnp.asarray(chi2_quantile(cfg.delta_outlier_reject, 2), dtype),
        r_fls_base=jnp.asarray(tf_fls_base.rot, dtype),
        t_fls_base=jnp.asarray(tf_fls_base.trans, dtype),
    )


def init_state(
    cfg: EKFSlamConfig = EKFSlamConfig(),
    mu0=None,
    beacons: np.ndarray | None = None,
    dtype=jnp.float32,
) -> SlamState:
    """Initial state; ``beacons`` pre-activates known-map landmark slots with
    the beacon prior covariance (``ekf_slam.cpp:141-175``)."""
    L = cfg.max_landmarks
    D = 6 + 3 * L
    mu = jnp.zeros(D, dtype)
    if mu0 is not None:
        mu = mu.at[0:6].set(jnp.asarray(mu0, dtype))
    Sigma = jnp.zeros((D, D), dtype)
    Sigma = Sigma.at[0:6, 0:6].set(jnp.diag(jnp.asarray(cfg.sigma0_diag, dtype)))
    active = jnp.zeros(L, bool)
    n = 0
    if beacons is not None and len(beacons):
        n = min(len(beacons), L)
        mu = mu.at[6 : 6 + 3 * n].set(
            jnp.asarray(np.asarray(beacons)[:n].reshape(-1), dtype)
        )
        bc = jnp.asarray(cfg.beacon_cov, dtype)
        for k in range(n):
            Sigma = Sigma.at[6 + 3 * k : 9 + 3 * k, 6 + 3 * k : 9 + 3 * k].set(jnp.diag(bc))
        active = active.at[:n].set(True)
    return SlamState(
        mu=mu,
        Sigma=Sigma,
        active=active,
        n_active=jnp.asarray(n, jnp.int32),
        mu_auv_odom=jnp.zeros(3, dtype),
    )


# ---------------------------------------------------------------------------
# motion predict
# ---------------------------------------------------------------------------

def predict(state: SlamState, odom_pose: jnp.ndarray, params: SlamParams) -> SlamState:
    """Consume one absolute odometry pose (``ekf_slam_core.cpp:41-121``)."""
    u_t = odom_pose[0:3] - state.mu_auv_odom
    mu = state.mu.at[0:3].add(u_t)
    mu = mu.at[3:6].set(wrap_angle(odom_pose[3:6]))

    g = jax.jacfwd(lambda a: rotmat_from_rpy(a) @ u_t)(mu[3:6])  # (3,3)
    # G = I except: G[0:3,3:6] = g, G[3:6,3:6] = 0 (absolute attitude)
    A = jnp.zeros((6, 6), mu.dtype)
    A = A.at[0:3, 0:3].set(jnp.eye(3, dtype=mu.dtype))
    A = A.at[0:3, 3:6].set(g)

    S = state.Sigma
    S11 = A @ S[0:6, 0:6] @ A.T + params.R
    S1L = A @ S[0:6, 6:]
    Sigma = S.at[0:6, 0:6].set(S11)
    Sigma = Sigma.at[0:6, 6:].set(S1L)
    Sigma = Sigma.at[6:, 0:6].set(S1L.T)
    return SlamState(
        mu=mu,
        Sigma=Sigma,
        active=state.active,
        n_active=state.n_active,
        mu_auv_odom=state.mu_auv_odom + u_t,
    )


# ---------------------------------------------------------------------------
# sensor models
# ---------------------------------------------------------------------------

def h_mbes(pose6: jnp.ndarray, lm: jnp.ndarray, params: SlamParams) -> jnp.ndarray:
    """Landmark in base frame (3,)."""
    return rotmat_from_rpy(pose6[3:6]).T @ (lm - pose6[0:3])


def backproject_mbes(z: jnp.ndarray, pose6: jnp.ndarray, params: SlamParams) -> jnp.ndarray:
    return rotmat_from_rpy(pose6[3:6]) @ z[0:3] + pose6[0:3]


def h_fls(pose6: jnp.ndarray, lm: jnp.ndarray, params: SlamParams) -> jnp.ndarray:
    """Pixel-space FLS measurement (2,): scaling·(‖(x,z)‖, −y) of the
    landmark in the FLS frame."""
    scale = 400.0 / 17.0
    v = params.r_fls_base @ h_mbes(pose6, lm, params) + params.t_fls_base
    rho = jnp.sqrt(v[0] ** 2 + v[2] ** 2 + 1e-12)
    return scale * jnp.stack([rho, -v[1]])


def backproject_fls(z: jnp.ndarray, pose6: jnp.ndarray, params: SlamParams) -> jnp.ndarray:
    """Pixels -> polar -> metres in FLS plane -> map frame
    (``correspondence_obj_fls.cpp:44-58``)."""
    scale_inv = 17.0 / 400.0
    x, y = z[0], -z[1]
    theta = jnp.arctan2(y, x)
    rho = scale_inv * jnp.sqrt(x * x + y * y)
    p_fls = jnp.stack([rho * jnp.cos(theta), rho * jnp.sin(theta), jnp.zeros_like(rho)])
    p_base = params.r_fls_base.T @ (p_fls - params.t_fls_base)
    return rotmat_from_rpy(pose6[3:6]) @ p_base + pose6[0:3]


# ---------------------------------------------------------------------------
# data association + sequential update (one sensor pass)
# ---------------------------------------------------------------------------

def _gather_idx9(slot: jnp.ndarray) -> jnp.ndarray:
    """State indices of the (pose, landmark slot) 9-marginal."""
    return jnp.concatenate([jnp.arange(6), 6 + 3 * slot + jnp.arange(3)])


def _gather9(Sigma: jnp.ndarray, slot: jnp.ndarray) -> jnp.ndarray:
    idx = _gather_idx9(slot)
    return Sigma[idx[:, None], idx[None, :]]


@dataclasses.dataclass(frozen=True)
class SensorSpec:
    """Static per-sensor dispatch (MBES / FLS)."""

    h: Callable          # (pose6, lm, params) -> (dim,)
    backproject: Callable
    dim: int
    q: Callable          # params -> (dim,dim)
    lam: Callable        # params -> scalar
    new_lm_cov: Tuple[float, ...]
    mh_dist: Callable    # cfg -> float


MBES = SensorSpec(
    h=h_mbes,
    backproject=backproject_mbes,
    dim=3,
    q=lambda p: p.Q_mbes,
    lam=lambda p: p.lambda_mbes,
    new_lm_cov=(100.0, 100.0, 100.0),
    mh_dist=lambda c: c.mhl_dist_mbes,
)

FLS = SensorSpec(
    h=h_fls,
    backproject=backproject_fls,
    dim=2,
    q=lambda p: p.Q_fls,
    lam=lambda p: p.lambda_fls,
    new_lm_cov=(400.0, 200.0, 1000.0),
    mh_dist=lambda c: c.mhl_dist_fls,
)


def da_stage(
    state: SlamState,
    z: jnp.ndarray,        # (M, 3) detections (FLS uses [:, :2])
    z_mask: jnp.ndarray,   # (M,)
    params: SlamParams,
    cfg: EKFSlamConfig,
    sensor: SensorSpec,
):
    """Pre-solver half of the DA pass: batch correspondence + candidates +
    the (L+M, M) cost table."""
    L = cfg.max_landmarks
    dim = sensor.dim
    mu, Sigma = state.mu, state.Sigma
    pose = mu[0:6]
    lm_all = mu[6:].reshape(L, 3)
    z_d = z[:, :dim]
    Q = sensor.q(params)
    lam = sensor.lam(params)
    f32 = mu.dtype

    # --- batch correspondence against every slot (h, H at pre-update μ̂) ----
    def corr(lm):
        zh = sensor.h(pose, lm, params)
        Hp = jax.jacfwd(lambda p6: sensor.h(p6, lm, params))(pose)   # (dim,6)
        Hl = jax.jacfwd(lambda l3: sensor.h(pose, l3, params))(lm)   # (dim,3)
        return zh, jnp.concatenate([Hp, Hl], axis=1)                  # (dim,9)

    z_hat, H = jax.vmap(corr)(lm_all)                                  # (L,dim),(L,dim,9)
    Spp = Sigma[0:6, 0:6]
    Spl = Sigma[0:6, 6:].reshape(6, L, 3).transpose(1, 0, 2)           # (L,6,3)
    Sll = jnp.einsum("iaib->iab", Sigma[6:, 6:].reshape(L, 3, L, 3))   # (L,3,3)
    Hp_, Hl_ = H[:, :, 0:6], H[:, :, 6:9]
    S = (
        jnp.einsum("ldi,ij,lej->lde", Hp_, Spp, Hp_)
        + jnp.einsum("ldi,lik,lek->lde", Hp_, Spl, Hl_)
        + jnp.einsum("ldk,lik,lei->lde", Hl_, Spl, Hp_)
        + jnp.einsum("ldi,lik,lek->lde", Hl_, Sll, Hl_)
        + Q
    )
    S_inv = inv_small(S)
    nu = z_d[None, :, :] - z_hat[:, None, :]                           # (L,M,dim)
    d_m = jnp.einsum("lmi,lij,lmj->lm", nu, S_inv, nu)                 # (L,M)

    cand = jax.vmap(lambda zi: sensor.backproject(zi, pose, params))(z)  # (M,3)

    def cand_corr(c, zi):
        zh = sensor.h(pose, c, params)
        Hp = jax.jacfwd(lambda p6: sensor.h(p6, c, params))(pose)
        Hl = jax.jacfwd(lambda l3: sensor.h(pose, l3, params))(c)
        Hc = jnp.concatenate([Hp, Hl], axis=1)
        Sig9c = jnp.zeros((9, 9), f32)
        Sig9c = Sig9c.at[0:6, 0:6].set(Sigma[0:6, 0:6])
        Sig9c = Sig9c.at[6:9, 6:9].set(jnp.diag(jnp.asarray(sensor.new_lm_cov, f32)))
        Sc = Hc @ Sig9c @ Hc.T + Q
        return Hc, inv_small(Sc), zi[:dim] - zh

    H_cand, S_inv_cand, nu_cand = jax.vmap(cand_corr)(cand, z)         # (M,...)

    M = z.shape[0]
    gate = (d_m < lam) & state.active[:, None] & z_mask[None, :]
    cost_known = jnp.where(gate, d_m, cfg.outlier_cost)                # (L,M)
    eye = jnp.eye(M, dtype=bool)
    cost_cand = jnp.where(eye, jnp.asarray(sensor.mh_dist(cfg), f32), cfg.outlier_cost)
    cost = jnp.concatenate([cost_known, cost_cand], axis=0)            # (L+M,M)

    staged = (H, S_inv, nu, cand, H_cand, S_inv_cand, nu_cand)
    return cost, staged


def data_associate_update(
    state: SlamState,
    z: jnp.ndarray,        # (M, 3) detections (FLS uses [:, :2])
    z_mask: jnp.ndarray,   # (M,)
    params: SlamParams,
    cfg: EKFSlamConfig,
    sensor: SensorSpec,
    solver: str = "device",
    update_mode: str = "full",
) -> Tuple[SlamState, jnp.ndarray]:
    """One batch-DA + sequential-update pass. Returns (state, col_to_row).

    ``update_mode``:
      * ``"full"`` (default) — correct EKF-SLAM update: the Kalman gain spans
        the whole padded state, so pose↔landmark cross-covariances stay
        consistent and Σ stays PSD under dense detection bursts.
      * ``"marginal"`` — reference fidelity: only the 9×9 (pose, matched
        landmark) marginal is written back (``ekf_slam_core.cpp:351-371``),
        leaving other cross-covariances stale. Structurally inconsistent —
        Σ can go indefinite under aggressive tunings (observed: dense
        8-detection bursts with small Q); usable with the reference's own
        gentle tuning (Q_mbes=200, mhl_dist=0.12).
    """
    # named scopes label the legs in a profiler trace (bench.py --trace)
    with jax.named_scope("slam_da_cost"):
        cost, staged = da_stage(state, z, z_mask, params, cfg, sensor)
    with jax.named_scope("slam_assign"):
        if solver == "device":
            col_to_row = assignment.hungarian(cost)
        else:
            col_to_row = assignment.hungarian_host(cost)
    with jax.named_scope("slam_update"):
        return da_commit(state, col_to_row, staged, z, z_mask, params, cfg,
                         sensor, update_mode)


def da_commit(
    state: SlamState,
    col_to_row: jnp.ndarray,
    staged,
    z: jnp.ndarray,
    z_mask: jnp.ndarray,
    params: SlamParams,
    cfg: EKFSlamConfig,
    sensor: SensorSpec,
    update_mode: str = "full",
) -> Tuple[SlamState, jnp.ndarray]:
    """Post-solver half of the DA pass: landmark adds + sequential update."""
    L = cfg.max_landmarks
    dim = sensor.dim
    if update_mode not in ("full", "marginal"):
        raise ValueError(f"update_mode must be 'full' or 'marginal', got {update_mode!r}")
    mu, Sigma = state.mu, state.Sigma
    M = z.shape[0]
    f32 = mu.dtype
    (H, S_inv, nu, cand, H_cand, S_inv_cand, nu_cand) = staged

    # --- sequential update in measurement order -----------------------------
    nu_known_per_obs = jnp.swapaxes(nu, 0, 1)                          # (M,L,dim)

    def upd2(carry, xs):
        mu, Sigma, active, n_active = carry
        r, valid, c_i, Hc_i, Sic_i, nuc_i, nu_row = xs
        is_new = r >= L
        r_clip = jnp.clip(r, 0, L - 1)
        can_add = is_new & (n_active < L)
        do = valid & (can_add | ~is_new)
        slot = jnp.where(is_new, n_active, r_clip)
        lm_ix = 6 + 3 * slot
        idx3 = lm_ix + jnp.arange(3)
        Dfull = Sigma.shape[0]

        add = do & is_new
        mu_add = jax.lax.dynamic_update_slice(mu, c_i.astype(f32), (lm_ix,))
        mu = jax.lax.select(add, mu_add, mu)
        Sigma_add = jax.lax.dynamic_update_slice(
            Sigma, jnp.zeros((3, Dfull), f32), (lm_ix, 0)
        )
        Sigma_add = jax.lax.dynamic_update_slice(
            Sigma_add, jnp.zeros((Dfull, 3), f32), (0, lm_ix)
        )
        Sigma_add = jax.lax.dynamic_update_slice(
            Sigma_add, jnp.diag(jnp.asarray(sensor.new_lm_cov, f32)), (lm_ix, lm_ix)
        )
        Sigma = jax.lax.select(add, Sigma_add, Sigma)
        active = jnp.where(add, active.at[slot].set(True), active)
        n_active = jnp.where(add, n_active + 1, n_active)

        H_i = jnp.where(is_new, Hc_i, H[r_clip])
        Sinv_i = jnp.where(is_new, Sic_i, S_inv[r_clip])
        nu_i = jnp.where(is_new, nuc_i, nu_row[r_clip])

        idx9 = _gather_idx9(slot)
        Sig9 = Sigma[idx9[:, None], idx9[None, :]]
        K = Sig9 @ H_i.T @ Sinv_i                                  # (9,dim)
        delta = K @ nu_i                                           # (9,)
        mu_new = mu.at[0:6].add(delta[0:6])
        mu_new = mu_new.at[3:6].set(wrap_angle(mu_new[3:6]))
        mu_new = jax.lax.dynamic_update_slice(
            mu_new,
            jax.lax.dynamic_slice(mu_new, (lm_ix,), (3,)) + delta[6:9],
            (lm_ix,),
        )
        Sig9_new = (jnp.eye(9, dtype=f32) - K @ H_i) @ Sig9
        Sigma_new = Sigma.at[idx9[:, None], idx9[None, :]].set(Sig9_new)

        mu = jax.lax.select(do, mu_new, mu)
        Sigma = jax.lax.select(do, Sigma_new, Sigma)
        return (mu, Sigma, active, n_active), jnp.where(do, slot, -1)

    def upd_lowrank(carry, xs):
        """Full-covariance sequential update with the Σ feedback carried as
        low-rank correction factors instead of the dense matrix.

        At update j the gain only needs the CURRENT Σ's nine (pose, slot)
        rows (Σ symmetric). With Σ_j = Σ_base − Σ_{k<j} U_kᵀ V_k
        (U_k = K_kᵀ, V_k = H_k Σ_j[idx9,:], both (dim, D)) those rows are a
        (M·dim)-rank correction of Σ0's rows — the scan carries ~40 KB
        instead of rewriting the dense (D, D) Σ eight times per tick.
        Everything is kept in (small, D) layout. Landmark
        activations are recorded as (slot, diag) pairs: inactive slots'
        rows/columns are zero by invariant, so activation is an additive
        diagonal block. Algebraically identical to the in-place sequence
        (one final symmetrize instead of per-update)."""
        mu, Ut, Vt, act_slots, act_cov_on, active, n_active, j = carry
        r, valid, c_i, Hc_i, Sic_i, nuc_i, nu_row = xs
        is_new = r >= L
        r_clip = jnp.clip(r, 0, L - 1)
        can_add = is_new & (n_active < L)
        do = valid & (can_add | ~is_new)
        slot = jnp.where(is_new, n_active, r_clip)
        lm_ix = 6 + 3 * slot
        Dfull = mu.shape[0]

        add = do & is_new
        mu_add = jax.lax.dynamic_update_slice(mu, c_i.astype(f32), (lm_ix,))
        mu = jax.lax.select(add, mu_add, mu)
        act_slots = jnp.where(add, act_slots.at[j].set(slot), act_slots)
        act_cov_on = jnp.where(add, act_cov_on.at[j].set(True), act_cov_on)
        active = jnp.where(add, active.at[slot].set(True), active)
        n_active = jnp.where(add, n_active + 1, n_active)

        H_i = jnp.where(is_new, Hc_i, H[r_clip])           # (dim,9)
        Sinv_i = jnp.where(is_new, Sic_i, S_inv[r_clip])   # (dim,dim)
        nu_i = jnp.where(is_new, nuc_i, nu_row[r_clip])    # (dim,)

        # current Σ's (pose, slot) ROWS: base + activation − corrections
        rows = jnp.concatenate(
            [Sigma0_pose_rows, jax.lax.dynamic_slice(Sigma, (lm_ix, 0), (3, Dfull))],
            axis=0,
        )                                                  # (9,D)
        was_act = jnp.any(act_cov_on & (act_slots == slot))
        diag_blk = jnp.diag(jnp.asarray(sensor.new_lm_cov, f32)) * was_act
        rows = jax.lax.dynamic_update_slice(
            rows,
            jax.lax.dynamic_slice(rows, (6, lm_ix), (3, 3)) + diag_blk,
            (6, lm_ix),
        )
        # corrections: rows(idx9) of Σ_k U_kᵀV_k = (U_k cols idx9)ᵀ V_k
        U9 = jnp.concatenate(
            [Ut[:, :, 0:6], jax.lax.dynamic_slice(Ut, (0, 0, lm_ix), (M, dim, 3))],
            axis=2,
        )                                                  # (M,dim,9)
        rows = rows - jnp.einsum("kir,kid->rd", U9, Vt)

        Kt = (Sinv_i @ H_i) @ rows                         # (dim,D) = Kᵀ
        delta = nu_i @ Kt                                  # (D,)
        mu_new = mu + delta
        mu_new = mu_new.at[3:6].set(wrap_angle(mu_new[3:6]))
        mu = jax.lax.select(do, mu_new, mu)

        Vt_i = H_i @ rows                                  # (dim,D)
        Ut = jnp.where(do, Ut.at[j].set(Kt), Ut)
        Vt = jnp.where(do, Vt.at[j].set(Vt_i), Vt)
        return (mu, Ut, Vt, act_slots, act_cov_on, active, n_active, j + 1), jnp.where(
            do, slot, -1
        )

    def upd_dense(carry, xs):
        """Full-covariance update carrying the dense Σ: one (D, D) rewrite
        per update, used up to 48 landmark slots (the low-rank form above
        carries (M, dim, D) factors instead)."""
        mu, Sigma, active, n_active = carry
        r, valid, c_i, Hc_i, Sic_i, nuc_i, nu_row = xs
        is_new = r >= L
        r_clip = jnp.clip(r, 0, L - 1)
        can_add = is_new & (n_active < L)
        do = valid & (can_add | ~is_new)
        slot = jnp.where(is_new, n_active, r_clip)
        lm_ix = 6 + 3 * slot
        Dfull = Sigma.shape[0]

        add = do & is_new
        mu_add = jax.lax.dynamic_update_slice(mu, c_i.astype(f32), (lm_ix,))
        mu = jax.lax.select(add, mu_add, mu)
        Sigma_add = jax.lax.dynamic_update_slice(
            Sigma, jnp.diag(jnp.asarray(sensor.new_lm_cov, f32)), (lm_ix, lm_ix)
        )  # inactive rows/cols are zero by invariant; diag set == add
        Sigma = jax.lax.select(add, Sigma_add, Sigma)
        active = jnp.where(add, active.at[slot].set(True), active)
        n_active = jnp.where(add, n_active + 1, n_active)

        H_i = jnp.where(is_new, Hc_i, H[r_clip])
        Sinv_i = jnp.where(is_new, Sic_i, S_inv[r_clip])
        nu_i = jnp.where(is_new, nuc_i, nu_row[r_clip])

        rows = jnp.concatenate(
            [Sigma[0:6, :], jax.lax.dynamic_slice(Sigma, (lm_ix, 0), (3, Dfull))],
            axis=0,
        )                                                          # (9,D)
        Kt = (Sinv_i @ H_i) @ rows                                 # (dim,D)
        delta = nu_i @ Kt
        mu_new = mu + delta
        mu_new = mu_new.at[3:6].set(wrap_angle(mu_new[3:6]))
        Vt_i = H_i @ rows                                          # (dim,D)
        Sigma_new = Sigma - Kt.T @ Vt_i
        Sigma_new = 0.5 * (Sigma_new + Sigma_new.T)

        mu = jax.lax.select(do, mu_new, mu)
        Sigma = jax.lax.select(do, Sigma_new, Sigma)
        return (mu, Sigma, active, n_active), jnp.where(do, slot, -1)

    xs = (col_to_row, z_mask, cand, H_cand, S_inv_cand, nu_cand, nu_known_per_obs)
    if update_mode == "marginal":
        carry0 = (mu, Sigma, state.active, state.n_active)
        (mu, Sigma, active, n_active), matched = jax.lax.scan(upd2, carry0, xs)
    elif L <= 48:
        carry0 = (mu, Sigma, state.active, state.n_active)
        (mu, Sigma, active, n_active), matched = jax.lax.scan(upd_dense, carry0, xs)
    else:
        D = mu.shape[0]
        Sigma0_pose_rows = Sigma[0:6, :]
        carry0 = (
            mu,
            jnp.zeros((M, dim, D), f32),
            jnp.zeros((M, dim, D), f32),
            jnp.full(M, -1, jnp.int32),
            jnp.zeros(M, bool),
            state.active,
            state.n_active,
            jnp.asarray(0, jnp.int32),
        )
        (mu, Ut, Vt, act_slots, act_cov_on, active, n_active, _), matched = jax.lax.scan(
            upd_lowrank, carry0, xs
        )
        # reconstruct Σ once: activations (additive diag blocks on zero
        # rows/cols) then the rank-(M·dim) correction, then symmetrize
        def apply_act(k, Sg):
            lm_ix = 6 + 3 * jnp.clip(act_slots[k], 0, L - 1)
            blk = jax.lax.dynamic_slice(Sg, (lm_ix, lm_ix), (3, 3)) + jnp.diag(
                jnp.asarray(sensor.new_lm_cov, f32)
            ) * act_cov_on[k]
            return jax.lax.dynamic_update_slice(Sg, blk, (lm_ix, lm_ix))

        Sigma = jax.lax.fori_loop(0, M, apply_act, Sigma)
        Sigma = Sigma - jnp.einsum("kid,kie->de", Ut, Vt)
        Sigma = 0.5 * (Sigma + Sigma.T)

    new_state = SlamState(
        mu=mu, Sigma=Sigma, active=active, n_active=n_active,
        mu_auv_odom=state.mu_auv_odom,
    )
    return new_state, matched


# ---------------------------------------------------------------------------
# full tick + replay
# ---------------------------------------------------------------------------

def step(
    cfg: EKFSlamConfig,
    params: SlamParams,
    state: SlamState,
    tick,
    solver: str = "device",
    update_mode: str = "full",
):
    """One SLAM tick (``ekf_slam.cpp:296-350``): consume latest odometry,
    then run a DA pass per sensor whose burst is non-empty."""
    odom = tick.channels["odom"]
    # accept either a 6-dim pose track or the 13-dim nav_msgs-style layout
    # [pos3, quat4, linvel3, angvel3] (static shape dispatch)
    if odom.value.shape[-1] >= 13:
        from ..utils.geometry import rpy_from_quat

        odom_pose = jnp.concatenate(
            [odom.value[0:3], rpy_from_quat(odom.value[3:7])]
        )
    else:
        odom_pose = odom.value[0:6]
    with jax.named_scope("slam_predict"):
        pred = predict(state, odom_pose, params)

    def run_pass(st, ev, sensor):
        def do_pass(s):
            s2, m = data_associate_update(
                s, ev.value, ev.mask, params, cfg, sensor, solver, update_mode
            )
            return s2, m

        def skip(s):
            return s, jnp.full(ev.mask.shape, -1, jnp.int32)

        return jax.lax.cond(jnp.any(ev.mask), do_pass, skip, st)

    st = pred
    matched_mbes = matched_fls = None
    if "mbes" in tick.events:
        st, matched_mbes = run_pass(st, tick.events["mbes"], MBES)
    if "fls" in tick.events:
        st, matched_fls = run_pass(st, tick.events["fls"], FLS)

    # gate: without odometry the reference rebroadcasts the last pose
    st = jax.tree_util.tree_map(
        lambda new, old: jnp.where(odom.valid, new, old), st, state
    )
    out = {
        "mu": st.mu[0:6],
        "sigma_diag6": jnp.diagonal(st.Sigma[0:6, 0:6]),
        "n_active": st.n_active,
    }
    if matched_mbes is not None:
        out["matched_mbes"] = matched_mbes
    if matched_fls is not None:
        out["matched_fls"] = matched_fls
    return st, out


def run(
    timeline: Timeline,
    params: SlamParams,
    cfg: EKFSlamConfig = EKFSlamConfig(),
    state0: SlamState | None = None,
    solver: str = "device",
    update_mode: str = "full",
):
    s0 = init_state(cfg) if state0 is None else state0

    def body(state, tick):
        return step(cfg, params, state, tick, solver, update_mode)

    return jax.lax.scan(body, s0, timeline)


def run_fleet(
    batched_timeline: Timeline,
    params: SlamParams,
    cfg: EKFSlamConfig = EKFSlamConfig(),
    update_mode: str = "full",
    device_mesh=None,
):
    """Fleet replay: ``run`` vmapped over the missions of a batched timeline
    (leaves (B, T, ...), as from ``parallel.fleet.batch_timelines``).

    Returns (final SlamState with a leading mission axis, out) where ``out``
    is time-major like a scan over the fleet: mu (T, B, 6), n_active (T, B),
    matched_<sensor> (T, B, M), sigma_diag6 (T, B, 6).

    ``device_mesh``: the fleet splits into one block of missions per device
    along the mesh's ``mission`` axis, and each device runs the one-device
    fleet program on its block (the dispatches overlap; missions are
    independent filters, so nothing crosses devices). Every device thus
    runs exactly the program one device would run on that block, and the
    result is bitwise the one-device fleet's. One SPMD program over the
    mesh is not: XLA partitions and fuses it differently, and on the GPU
    that moved poses and Σ by ulps from the second tick on. Call it outside
    ``jit`` (the timeline must be concrete); the outputs are global arrays
    sharded over the mission axis."""
    if device_mesh is not None:
        from ..parallel.mesh import map_mission_blocks

        def split(result):
            # final state is batch-major, per-tick outputs are time-major
            final, out = result
            return (jax.tree_util.tree_map(lambda _: 0, final),
                    jax.tree_util.tree_map(lambda _: 1, out))

        return map_mission_blocks(
            functools.partial(_fleet_program, cfg=cfg, update_mode=update_mode),
            batched_timeline, device_mesh, split, shared=(params,))

    final, out = jax.vmap(
        lambda tl: run(tl, params, cfg, update_mode=update_mode)
    )(batched_timeline)
    return final, jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, 0, 1), out)


@functools.partial(jax.jit, static_argnames=("cfg", "update_mode"))
def _fleet_program(batched_timeline, params, cfg, update_mode):
    """The one-device fleet program each device of a mission mesh runs."""
    return run_fleet(batched_timeline, params, cfg, update_mode)



def map_to_odom_correction(mu_pose: jnp.ndarray, odom_pose: jnp.ndarray) -> Transform:
    """tf map->odom correction (``bcMapOdomTF``, ``ekf_slam.cpp:263-294``):
    composes the filter's map->base estimate with the inverse of the raw
    odom->base odometry."""
    t_map_base = Transform.from_pose(mu_pose)
    t_odom_base = Transform.from_pose(odom_pose)
    return t_map_base.compose(t_odom_base.inverse())


def slam_timeline(
    mission,
    odom_track: np.ndarray,
    odom_ticks: np.ndarray,
    cfg: EKFSlamConfig = EKFSlamConfig(),
) -> Timeline:
    """SLAM timeline: odometry channel (from a DR provider run) + MBES events."""
    det = mission.streams["mbes_detections"]
    return build_timeline(
        t0=0.0,
        t1=mission.spec.duration_s,
        freq_hz=cfg.system_freq,
        channels={"odom": (odom_ticks, odom_track)},
        events={"mbes": (det["stamps"], det["values"], det["burst"], cfg.max_obs)},
    )


def landmarks_map(state: SlamState, cfg: EKFSlamConfig) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Current landmark estimates: (L,3) positions + active mask (the RViz
    marker output of the reference, ``ekf_slam.cpp:201-233``)."""
    return state.mu[6:].reshape(cfg.max_landmarks, 3), state.active

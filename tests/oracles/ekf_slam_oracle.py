"""NumPy float64 oracle of the EKF-SLAM tick (MBES and FLS paths).

Independent transcription of the REFERENCE C++ core — derived from
``/root/reference/auv_ekf_slam/src/ekf_slam_core.cpp``,
``src/correspondence_obj_mbes.cpp``, ``src/correspondence_obj_fls.cpp``
and ``utils/ekf_utils.cpp`` directly (NOT from the JAX module), so a
shared misreading between implementation and oracle cannot hide.
Per-method citations below. Analytic Jacobians are transcribed
term-by-term from the C++ expressions (no numeric differentiation, no
jax).

The padded-state adaptations (fixed landmark bank, z_mask for empty
detection slots) replace the reference's conservativeResize growth; the
association/update *decisions* are unchanged by them.

Covariance writeback modes:
  * ``marginal`` — the reference's own semantics: only the 9x9 (pose,
    matched landmark) blocks are written back (``ekf_slam_core.cpp:
    351-371``).
  * ``full`` — the rebuild's default divergence: whole-state Kalman gain
    (consistent cross-covariances; see README "Known divergences").
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment
from scipy.stats import chi2


def rotmat(rpy):
    """R(roll, pitch, yaw) = Rz(yaw) Ry(pitch) Rx(roll) — the convention of
    tf::createQuaternionFromRPY used at ``ekf_slam_core.cpp:197``."""
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    return np.array(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ]
    )


def wrap(a):
    """``utils::angleLimit`` (ekf_utils.cpp:50-52) for in-range inputs;
    python mod keeps the result in [-pi, pi) for all inputs."""
    return np.mod(a + np.pi, 2 * np.pi) - np.pi


def motion_jacobian_g(u, rpy):
    """g_t: d(R(rpy)·u)/d(rpy), transcribed from ``ekf_slam_core.cpp:
    84-107`` (evaluated at the POST-update absolute angles, as the C++
    does — mu_hat_(3:5) are set before g_t is built)."""
    u0, u1, u2 = u
    c3, s3 = np.cos(rpy[0]), np.sin(rpy[0])
    c4, s4 = np.cos(rpy[1]), np.sin(rpy[1])
    c5, s5 = np.cos(rpy[2]), np.sin(rpy[2])
    g = np.zeros((3, 3))
    # rows follow :88-107 exactly (columns 3..5 of the 6x6 g_t)
    g[0, 0] = u1 * (s3 * s5 + c3 * c5 * s4) + u2 * (c3 * s5 - c5 * s4 * s3)
    g[0, 1] = c5 * (u2 * c4 * c3 - u0 * s4 + u1 * c4 * s3)
    g[0, 2] = (
        u2 * (c5 * s3 - c3 * s4 * s5)
        - u1 * (c3 * c5 + s4 * s3 * s5)
        - u0 * c4 * s5
    )
    g[1, 0] = -u1 * (c5 * s3 - c3 * s4 * s5) - u2 * (c3 * c5 + s4 * s3 * s5)
    g[1, 1] = s5 * (u2 * c4 * c3 - u0 * s4 + u1 * c4 * s3)
    g[1, 2] = (
        u2 * (s3 * s5 + c3 * c5 * s4)
        - u1 * (c3 * s5 - c5 * s4 * s3)
        + u0 * c4 * c5
    )
    g[2, 0] = c4 * (u1 * c3 - u2 * s3)
    g[2, 1] = -u0 * c4 - u2 * c3 * s4 - u1 * s4 * s3
    g[2, 2] = 0.0
    return g


def mbes_H(pose, lm):
    """3x9 measurement Jacobian, transcribed term-by-term from
    ``correspondence_obj_mbes.cpp:61-107`` (h_comps: mu_0..2 = position,
    3=roll, 4=pitch, 5=yaw; columns 0..5 pose, 6..8 landmark)."""
    mu0, mu1, mu2 = pose[0:3]
    c3, s3 = np.cos(pose[3]), np.sin(pose[3])
    c4, s4 = np.cos(pose[4]), np.sin(pose[4])
    c5, s5 = np.cos(pose[5]), np.sin(pose[5])
    lx, ly, lz = lm
    H = np.zeros((3, 9))
    H[0, 0] = -c4 * c5
    H[0, 1] = -c4 * s5
    H[0, 2] = s4
    H[0, 3] = 0.0
    H[0, 4] = (mu2 * c4 - lz * c4 - lx * c5 * s4 - ly * s4 * s5
               + mu0 * c5 * s4 + mu1 * s4 * s5)
    H[0, 5] = c4 * (ly * c5 - lx * s5 - mu1 * c5 + mu0 * s5)

    H[1, 0] = c3 * s5 - c5 * s4 * s3
    H[1, 1] = -c3 * c5 - s4 * s3 * s5
    H[1, 2] = -c4 * s3
    H[1, 3] = (lz * c4 * c3 - mu2 * c4 * c3 - ly * c5 * s3 + lx * s3 * s5
               + mu1 * c5 * s3 - mu0 * s3 * s5 + lx * c3 * c5 * s4
               + ly * c3 * s4 * s5 - mu0 * c3 * c5 * s4 - mu1 * c3 * s4 * s5)
    H[1, 4] = -s3 * (lz * s4 - mu2 * s4 - lx * c4 * c5 - ly * c4 * s5
                     + mu0 * c4 * c5 + mu1 * c4 * s5)
    H[1, 5] = (mu0 * c3 * c5 - ly * c3 * s5 - lx * c3 * c5 + mu1 * c3 * s5
               + ly * c5 * s4 * s3 - lx * s4 * s3 * s5
               - mu1 * c5 * s4 * s3 + mu0 * s4 * s3 * s5)

    H[2, 0] = -s3 * s5 - c3 * c5 * s4
    H[2, 1] = c5 * s3 - c3 * s4 * s5
    H[2, 2] = -c4 * c3
    H[2, 3] = (lx * c3 * s5 - lz * c4 * s3 - ly * c3 * c5 + mu1 * c3 * c5
               + mu2 * c4 * s3 - mu0 * c3 * s5 - lx * c5 * s4 * s3
               - ly * s4 * s3 * s5 + mu0 * c5 * s4 * s3 + mu1 * s4 * s3 * s5)
    H[2, 4] = -c3 * (lz * s4 - mu2 * s4 - lx * c4 * c5 - ly * c4 * s5
                     + mu0 * c4 * c5 + mu1 * c4 * s5)
    H[2, 5] = (lx * c5 * s3 + ly * s3 * s5 - mu0 * c5 * s3 - mu1 * s3 * s5
               + ly * c3 * c5 * s4 - lx * c3 * s4 * s5
               - mu1 * c3 * c5 * s4 + mu0 * c3 * s4 * s5)

    H[0, 6] = c4 * c5
    H[0, 7] = c4 * s5
    H[0, 8] = -s4
    H[1, 6] = c5 * s4 * s3 - c3 * s5
    H[1, 7] = c3 * c5 + s4 * s3 * s5
    H[1, 8] = c4 * s3
    H[2, 6] = s3 * s5 + c3 * c5 * s4
    H[2, 7] = c3 * s4 * s5 - c5 * s3
    H[2, 8] = c4 * c3
    return H


_FLS_SCALE = 400.0 / 17.0   # px per metre (correspondence_obj_fls.cpp:27)


def fls_h2(v):
    """h₂ (2×3 pixel projection Jacobian, ``correspondence_obj_fls.cpp:
    78-85``) evaluated at the expected measurement v in FLS-frame metres:
    row 0 = scaling·(x,0,z)/‖(x,0,z)‖, row 1 = −scaling·e_y."""
    zp = np.array([v[0], 0.0, v[2]])
    h2 = np.zeros((2, 3))
    h2[0] = zp / np.linalg.norm(zp)
    h2[1, 1] = -1.0
    return _FLS_SCALE * h2


def fls_H(pose, lm, r_fls_base, v):
    """2×9 FLS measurement Jacobian H = h₂·(R_fls_base·h₁)
    (``correspondence_obj_fls.cpp:61-135``). The 3×9 h₁ there is
    term-identical to the MBES Jacobian (compare :87-131 against
    ``correspondence_obj_mbes.cpp:47-108``), so it is shared."""
    return fls_h2(v) @ (r_fls_base @ mbes_H(pose, lm))


class OracleSLAM:
    def __init__(self, cfg, update_mode="full", sensor="mbes",
                 r_base_fls=None, t_base_fls=None):
        self.cfg = cfg
        self.L = cfg.max_landmarks
        D = 6 + 3 * self.L
        self.mu = np.zeros(D)
        self.Sigma = np.zeros((D, D))
        self.Sigma[:6, :6] = np.diag(cfg.sigma0_diag)
        self.active = np.zeros(self.L, bool)
        self.n_active = 0
        self.mu_auv_odom = np.zeros(3)
        self.R = np.diag(cfg.r_diag)         # ekf_slam.cpp:74-97 diagonals
        # FLS extrinsic: tf_base_sensor_ (base <- fls, ekf_slam_core.cpp:32)
        # and its inverse tf_sensor_base_ (:33) whose rotation is h_comps.
        # R_fls_base_ (:203)
        self.r_bs = np.eye(3) if r_base_fls is None else np.asarray(r_base_fls)
        self.t_bs = np.zeros(3) if t_base_fls is None else np.asarray(t_base_fls)
        self.r_sb = self.r_bs.T
        self.t_sb = -self.r_sb @ self.t_bs
        self.use_sensor(sensor)
        self.update_mode = update_mode

    def use_sensor(self, sensor):
        """Select the correspondence object (MBES or FLS) for the next DA
        pass — the frame_id dispatch of ``ekf_slam.cpp:323``."""
        cfg = self.cfg
        self.sensor = sensor
        if sensor == "mbes":
            self.dim = 3
            self.Q = np.diag(cfg.q_mbes_diag)
            self.new_lm_cov = np.asarray(cfg.new_lm_cov_mbes)
            self.mh_dist = cfg.mhl_dist_mbes
        else:
            self.dim = 2
            self.Q = np.diag(cfg.q_fls_diag)
            self.new_lm_cov = np.asarray(cfg.new_lm_cov_fls)
            self.mh_dist = cfg.mhl_dist_fls
        # lambda_M = chi2(dim) quantile at delta (ekf_slam.cpp:100-103)
        self.lam = chi2.ppf(cfg.delta_outlier_reject, self.dim)

    def h_fls_m(self, pose, lm):
        """Expected measurement in FLS-frame metres: T_sensor_map·lm with
        tf_sensor_map = tf_sensor_base·tf_base_map (ekf_slam_core.cpp:
        153-156)."""
        return self.r_sb @ (rotmat(pose[3:6]).T @ (lm - pose[0:3])) + self.t_sb

    def h(self, pose, lm):
        """measModel. MBES (correspondence_obj_mbes.cpp:26-35): z_hat =
        T_base_map·lm. FLS (correspondence_obj_fls.cpp:25-41): pixel pair
        (scaling·‖(x,z)‖, −scaling·y) of the FLS-frame point."""
        if self.sensor == "mbes":
            return rotmat(pose[3:6]).T @ (lm - pose[0:3])
        v = self.h_fls_m(pose, lm)
        return np.array([_FLS_SCALE * np.hypot(v[0], v[2]), -_FLS_SCALE * v[1]])

    def H(self, pose, lm):
        if self.sensor == "mbes":
            return mbes_H(pose, lm)
        return fls_H(pose, lm, self.r_sb, self.h_fls_m(pose, lm))

    def backproject(self, pose, z):
        """backProjectNewLM. MBES (correspondence_obj_mbes.cpp:39-44):
        T_map_base·z. FLS (correspondence_obj_fls.cpp:44-58): pixels →
        polar → metres in the FLS plane → T_map_sensor·p with
        tf_map_sensor = tf_map_base·tf_base_sensor (:240)."""
        if self.sensor == "mbes":
            return rotmat(pose[3:6]) @ z + pose[0:3]
        x, y = z[0], -z[1]
        theta = np.arctan2(y, x)
        rho = (17.0 / 400.0) * np.hypot(x, y)
        p_fls = np.array([rho * np.cos(theta), rho * np.sin(theta), 0.0])
        p_base = self.r_bs @ p_fls + self.t_bs
        return rotmat(pose[3:6]) @ p_base + pose[0:3]

    def predict(self, odom_pose):
        """predictMotion (ekf_slam_core.cpp:41-120): position increment
        u_t = odom − mu_auv_odom (:62-69), ABSOLUTE wrapped RPY from the
        odom orientation (:72-81), g_t at the new angles (:84-107), G_t =
        identity with zeroed angle diagonal + Fᵀ g F (:110-114), Σ̂ =
        GΣGᵀ + FᵀRF (:117-118)."""
        u = odom_pose[0:3] - self.mu_auv_odom
        self.mu[0:3] += u
        self.mu[3:6] = wrap(odom_pose[3:6])
        self.mu_auv_odom += u
        g = motion_jacobian_g(u, self.mu[3:6])
        A = np.zeros((6, 6))          # top-left of G_t: [[I, g], [0, 0]]
        A[0:3, 0:3] = np.eye(3)
        A[0:3, 3:6] = g
        S = self.Sigma
        S11 = A @ S[0:6, 0:6] @ A.T + self.R
        S1L = A @ S[0:6, 6:]
        S[0:6, 0:6] = S11
        S[0:6, 6:] = S1L
        S[6:, 0:6] = S1L.T

    def _idx9(self, slot):
        """updateMatrixBlock gather order (ekf_utils.cpp:18-23): pose block
        then the landmark's 3 rows."""
        return np.concatenate([np.arange(6), 6 + 3 * slot + np.arange(3)])

    def da_update(self, z_t, z_mask):
        """batchDataAssociation (ekf_slam_core.cpp:184-348): candidate
        back-projection + temporary augmentation (:246-252), (L+M)×M
        Mahalanobis cost table with χ² outlier substitution (:161-179),
        fixed new-landmark diagonal (:269-281), optimal assignment
        (:283-304, Munkres there, scipy LAP here — both exact minima),
        then updates in measurement order on assigned cells (:317-340)."""
        cfg, L = self.cfg, self.L
        pose = self.mu[0:6]
        M = len(z_t)

        # batch stage: H / S⁻¹ / ν at the pre-update state (stored in
        # corresp_list in the C++, reused unchanged during the updates)
        H_all, Sinv_all, nu_all = {}, {}, {}
        cost = np.full((L + M, M), cfg.outlier_cost)
        for j in range(L):
            lm = self.mu[6 + 3 * j : 9 + 3 * j]
            zh = self.h(pose, lm)
            H = self.H(pose, lm)
            idx = self._idx9(j)
            Sig9 = self.Sigma[np.ix_(idx, idx)]
            S = H @ Sig9 @ H.T + self.Q        # computeMHLDistance :110-116
            Sinv = np.linalg.inv(S)
            H_all[j], Sinv_all[j] = H, Sinv
            for i in range(M):
                nu = z_t[i] - zh                # computeNu :118-120
                nu_all[(j, i)] = nu
                if self.active[j] and z_mask[i]:
                    d = nu @ Sinv @ nu
                    if d < self.lam:            # outlier gate :173-179
                        cost[j, i] = d

        # candidates: rows L+i with mh_dist on the diagonal (:269-281);
        # their correspondence objects use the augmented marginal (pose
        # block + diag(new_lm_cov), zero cross terms) exactly as the
        # temporarily grown Sigma_hat_temp provides (:246-252)
        cands, H_c, Sinv_c, nu_c = [], [], [], []
        for i in range(M):
            c = self.backproject(pose, z_t[i])
            cands.append(c)
            H = self.H(pose, c)
            Sig9 = np.zeros((9, 9))
            Sig9[0:6, 0:6] = self.Sigma[0:6, 0:6]
            Sig9[6:9, 6:9] = np.diag(self.new_lm_cov)  # :222-240 per sensor
            S = H @ Sig9 @ H.T + self.Q
            H_c.append(H)
            Sinv_c.append(np.linalg.inv(S))
            nu_c.append(z_t[i] - self.h(pose, c))
            cost[L + i, i] = self.mh_dist
        rows, cols = linear_sum_assignment(cost)
        col_to_row = np.full(M, -1)
        col_to_row[cols] = rows

        matched = np.full(M, -1)
        for i in range(M):  # measurement order, like :319
            if not z_mask[i]:
                continue
            r = col_to_row[i]
            is_new = r >= L
            if is_new:
                # addLMtoFilter (ekf_utils.cpp:25-44): grow with zero
                # rows/cols + diag(new_lm_cov); here = activate a slot
                if self.n_active >= L:
                    continue
                slot = self.n_active
                ix = 6 + 3 * slot
                self.mu[ix : ix + 3] = cands[i]
                self.Sigma[ix : ix + 3, :] = 0.0
                self.Sigma[:, ix : ix + 3] = 0.0
                self.Sigma[ix : ix + 3, ix : ix + 3] = np.diag(self.new_lm_cov)
                self.active[slot] = True
                self.n_active += 1
                H, Sinv, nu = H_c[i], Sinv_c[i], nu_c[i]
            else:
                slot = r
                H, Sinv, nu = H_all[r], Sinv_all[r], nu_all[(r, i)]

            # sequentialUpdate (:351-371): FRESH 9x9 marginal gather, the
            # batch-stage H/S⁻¹/ν, angle wrap after the pose update
            idx = self._idx9(slot)
            if self.update_mode == "marginal":
                Sig9 = self.Sigma[np.ix_(idx, idx)]
                K = Sig9 @ H.T @ Sinv                     # :355
                delta = K @ nu                            # :358
                self.mu[0:6] += delta[0:6]                # :360
                self.mu[3:6] = wrap(self.mu[3:6])         # :361-363
                self.mu[idx[6:]] += delta[6:9]            # :364
                Sig9n = (np.eye(9) - K @ H) @ Sig9        # :366
                self.Sigma[np.ix_(idx, idx)] = Sig9n      # :367-370
            else:
                # full-covariance divergence: gain over the whole state
                Sig_cols = self.Sigma[:, idx]
                K = Sig_cols @ (H.T @ Sinv)
                delta = K @ nu
                self.mu += delta
                self.mu[3:6] = wrap(self.mu[3:6])
                HS = H @ Sig_cols.T
                self.Sigma = self.Sigma - K @ HS
                self.Sigma = 0.5 * (self.Sigma + self.Sigma.T)
            matched[i] = slot
        return matched

    def step(self, odom_pose, odom_valid, z_t, z_mask):
        """ekfLocalize tick (ekf_slam.cpp:296-350): predict from the latest
        odom, update when measurements arrived, commit (ekfUpdate
        :373-387 — the padded state needs no resize)."""
        if not odom_valid:
            return self.mu[0:6].copy(), np.full(len(z_t), -1)
        self.predict(odom_pose)
        matched = (
            self.da_update(z_t, z_mask)
            if np.any(z_mask)
            else np.full(len(z_t), -1)
        )
        return self.mu[0:6].copy(), matched


def run_oracle(cfg, timeline_np, update_mode="full", sensor="mbes",
               r_base_fls=None, t_base_fls=None):
    o = OracleSLAM(cfg, update_mode, sensor=sensor,
                   r_base_fls=r_base_fls, t_base_fls=t_base_fls)
    T = len(timeline_np["ticks"])
    mus = np.zeros((T, 6))
    matched = []
    for k in range(T):
        mu, m = o.step(
            timeline_np["odom_value"][k][0:6],
            timeline_np["odom_valid"][k],
            timeline_np["det_value"][k],
            timeline_np["det_mask"][k],
        )
        mus[k] = mu
        matched.append(m)
    return mus, np.stack(matched), o


def rpy_from_quat(q):
    """xyzw quaternion -> (roll, pitch, yaw), tf's euler_from_quaternion
    convention (the inverse of ``rotmat`` above)."""
    x, y, z, w = np.asarray(q, np.float64)
    roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1.0, 1.0))
    yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return np.array([roll, pitch, yaw])


def timeline_arrays(tl, mission=None, sensor="mbes"):
    """float64 numpy view of a SLAM Timeline for ``run_oracle``; with
    ``mission`` set, lane ``mission`` of a batched (B, T, ...) timeline.
    A 13-wide odom channel ([pos3, quat4, ...]) becomes the 6-wide
    [pos3, rpy3] pose the filter consumes."""
    pick = (lambda x: np.asarray(x)) if mission is None else (
        lambda x: np.asarray(x)[mission])
    od, ev = tl.channels["odom"], tl.events[sensor]
    odom = pick(od.value).astype(np.float64)
    if odom.shape[-1] >= 13:
        odom = np.concatenate(
            [odom[:, 0:3], np.stack([rpy_from_quat(q) for q in odom[:, 3:7]])],
            axis=1)
    det = pick(ev.value).astype(np.float64)
    return {
        "ticks": pick(tl.ticks).astype(np.float64),
        "odom_value": odom,
        "odom_valid": pick(od.valid),
        "det_value": det[:, :, :2] if sensor == "fls" else det,
        "det_mask": pick(ev.mask),
    }

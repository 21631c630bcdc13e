"""Marginal-writeback fleets vs the f64 oracle's marginal mode.

The reference's own sequential update writes back only the 9x9
(pose, matched-landmark) marginal (``ekf_slam_core.cpp:351-371``,
``utils/ekf_utils.cpp:18-23``) — ``run(update_mode="marginal")`` is the
transcription of those semantics and ``run_fleet(update_mode="marginal")``
is that filter vmapped over missions. Association decisions must MATCH
the oracle EXACTLY; trajectories and covariances agree to f32 tolerance.
"""

import dataclasses

import numpy as np

from smarc_navigation_tpu.configs import EKFSlamConfig
from smarc_navigation_tpu.models import ekf_slam as slam
from smarc_navigation_tpu.parallel import fleet

from test_slam_fleet import _fls_tls, _slam_tls, assert_fleet_matches_oracle


def _cfg():
    return dataclasses.replace(
        EKFSlamConfig(), max_landmarks=16, max_obs=4,
        mhl_dist_mbes=1.0, q_mbes_diag=(0.1,) * 3, r_diag=(1e-3,) * 6)


def test_marginal_cross_landmark_blocks_stay_zero():
    """The invariant the kernel carry is built on: under marginal
    semantics the dense path's cross-LANDMARK covariance blocks are
    exactly zero at every tick (predict touches pose rows/cols only,
    updates touch pose x pose, pose x own-lm, own-lm x own-lm)."""
    cfg = _cfg()
    params = slam.make_params(cfg)
    (tl,) = _slam_tls(cfg, 6.0, [1])
    final, _ = slam.run(tl, params, cfg, update_mode="marginal")
    L = cfg.max_landmarks
    Sig = np.asarray(final.Sigma)
    for i in range(L):
        for j in range(L):
            if i == j:
                continue
            blk = Sig[6 + 3 * i:9 + 3 * i, 6 + 3 * j:9 + 3 * j]
            assert np.all(blk == 0.0), (i, j, blk)


def test_run_fleet_marginal_matches_dense_marginal():
    cfg = _cfg()
    params = slam.make_params(cfg)
    tls = _slam_tls(cfg, 6.0, [1, 2])
    batched = fleet.batch_timelines(tls)

    final_f, out_f = slam.run_fleet(batched, params, cfg,
                                    update_mode="marginal")
    oracles = assert_fleet_matches_oracle(cfg, batched, out_f, final_f,
                                          "marginal")

    for b, o in enumerate(oracles):
        # covariance: pose rows + landmark diag blocks agree with the
        # oracle's marginal Sigma to f32 tolerance
        Sd = o.Sigma
        Sf = np.asarray(final_f.Sigma[b])
        np.testing.assert_allclose(Sf[0:6, :], Sd[0:6, :], atol=2e-2)
        L = cfg.max_landmarks
        for l in range(L):
            s = slice(6 + 3 * l, 9 + 3 * l)
            np.testing.assert_allclose(Sf[s, s], Sd[s, s], atol=2e-2)


def test_run_fleet_marginal_fls():
    """FLS (dim=2) pass through the marginal fleet vs the oracle."""
    cfg = dataclasses.replace(
        EKFSlamConfig(), max_landmarks=16, max_obs=8,
        mhl_dist_fls=3.0, q_fls_diag=(4.0, 4.0), r_diag=(1e-3,) * 6)
    params = slam.make_params(cfg)
    batched = fleet.batch_timelines(_fls_tls(cfg, 6.0, [1, 2]))
    final_f, out_f = slam.run_fleet(batched, params, cfg,
                                    update_mode="marginal")
    assert int(np.asarray(final_f.n_active).min()) > 0
    assert_fleet_matches_oracle(cfg, batched, out_f, final_f, "marginal",
                                sensors=("fls",))

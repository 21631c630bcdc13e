"""Particle-filter noise and resampling on the plain XLA path.

* The motion noise and the resample jitter are ``jax.random`` threefry
  draws: their statistics match the configured covariances.
* With ``jax_threefry_partitionable`` the draws do not depend on how the
  bank is sharded, so a particle-sharded ``pf.run`` reproduces the
  unsharded bank bitwise at any shard count.
* Systematic-resample ancestors equal a float64 NumPy systematic resample
  on the same weights and uniform draw, up to f32 CDF ties.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smarc_navigation_tpu.configs import PFConfig
from smarc_navigation_tpu.io import sim
from smarc_navigation_tpu.models import particle_filter as pf
from smarc_navigation_tpu.ops import resampling
from smarc_navigation_tpu.parallel import mesh as mesh_lib

N_STAT = 1 << 16


def _still_odom():
    """13-wide odom of a vehicle at rest: identity attitude, no motion."""
    return jnp.asarray([0, 0, -1.0, 0, 0, 0, 1.0] + [0.0] * 6, jnp.float32)


def _moments_ok(samples, var, tag):
    """Sample mean within 5 standard errors of 0 and sample variance within
    5 standard errors of ``var`` (chi-square: se(var) = var·sqrt(2/n))."""
    n = samples.size
    m, v = float(samples.mean()), float(samples.var())
    assert abs(m) < 5 * np.sqrt(var / n), (tag, m)
    assert abs(v - var) < 5 * var * np.sqrt(2.0 / n), (tag, v, var)


@pytest.mark.parametrize("row,cov_idx", [(0, 0), (1, 1), (5, 5)])
def test_motion_noise_statistics(row, cov_idx):
    cfg = dataclasses.replace(PFConfig(), motion_cov=(0.04, 0.09, 0.0, 0.0, 0.0, 0.01))
    params = pf.make_params(cfg)
    st = pf.PFState(particles=jnp.zeros((6, N_STAT), jnp.float32),
                    key=jax.random.PRNGKey(3), t_prev=jnp.float32(0))
    out = jax.jit(lambda s: pf.predict(s, _still_odom(), 1.0, params))(st)
    _moments_ok(np.asarray(out.particles[row], np.float64),
                cfg.motion_cov[cov_idx], ("motion", row))


def test_motion_noise_rows_independent():
    cfg = dataclasses.replace(PFConfig(), motion_cov=(0.04, 0.04, 0.0, 0.0, 0.0, 0.04))
    params = pf.make_params(cfg)
    st = pf.PFState(particles=jnp.zeros((6, N_STAT), jnp.float32),
                    key=jax.random.PRNGKey(4), t_prev=jnp.float32(0))
    p = np.asarray(pf.predict(st, _still_odom(), 1.0, params).particles, np.float64)
    c = np.corrcoef(p[[0, 1, 5]])
    off = c[~np.eye(3, dtype=bool)]
    assert np.abs(off).max() < 5 / np.sqrt(N_STAT), c


@pytest.mark.parametrize("scheme", ["systematic", "residual"])
def test_resample_jitter_statistics(scheme):
    """Identical particles resample to identical copies, so what the update
    leaves is exactly the jitter: N(0, res_noise_cov) per state row."""
    cfg = dataclasses.replace(PFConfig(), res_noise_cov=(0.01, 0.02, 0.0, 0.0, 0.0, 0.005))
    params = pf.make_params(cfg)
    st = pf.PFState(particles=jnp.zeros((6, N_STAT), jnp.float32),
                    key=jax.random.PRNGKey(5), t_prev=jnp.float32(0))
    out = jax.jit(lambda s: pf.update_resample(
        s, jnp.asarray([0.3, -0.2], jnp.float32), params, scheme))(st)
    p = np.asarray(out.particles, np.float64)
    for row in (0, 1, 5):
        _moments_ok(p[row], cfg.res_noise_cov[row], (scheme, row))
    assert np.all(p[2:5] == 0.0)  # zero-variance rows stay exact


def test_predict_noise_shard_invariant():
    """The same key gives the same motion noise whether the bank lives on one
    device or is sharded over eight."""
    params = pf.make_params(PFConfig())
    st = pf.init_state(N_STAT, params, key=jax.random.PRNGKey(6))
    ref = jax.jit(lambda s: pf.predict(s, _still_odom(), 0.1, params))(st)
    pm = mesh_lib.make_mesh(mission=1, particle=8)
    sh = jax.sharding.NamedSharding(pm, jax.sharding.PartitionSpec(None, "particle"))
    st_sh = st._replace(particles=jax.device_put(st.particles, sh))
    got = jax.jit(lambda s: pf.predict(s, _still_odom(), 0.1, params))(st_sh)
    assert len(got.particles.sharding.device_set) == 8
    np.testing.assert_array_equal(np.asarray(got.particles), np.asarray(ref.particles))


@pytest.fixture(scope="module")
def pf_mission():
    m = sim.simulate(sim.MissionSpec(duration_s=4.0, seed=3, gps_surface_z=-100.0))
    tl = pf.pf_timeline(m, freq_hz=10.0)
    n = 8 * resampling.CDF_BLOCK
    cfg = PFConfig(particle_count=n)
    params = pf.make_params(cfg)
    key = jax.random.PRNGKey(21)
    ref = jax.jit(lambda t: pf.run(t, params, cfg, key=key, scheme="systematic"))(tl)
    return tl, cfg, params, key, ref


@pytest.mark.parametrize("particle_ax", [1, 2, 4, 8])
def test_pf_run_shard_count_invariant(pf_mission, particle_ax):
    """Full mission with GPS updates through ``pf.run(pmesh=...)`` at 1, 2,
    4 and 8 particle shards: the bank is bitwise the unsharded one, the
    moments agree to reduction-order ulps."""
    tl, cfg, params, key, (f_ref, o_ref) = pf_mission
    assert int(np.asarray(o_ref["updated"]).sum()) >= 3
    pm = mesh_lib.make_mesh(mission=8 // particle_ax, particle=particle_ax)
    f_sh, o_sh = jax.jit(lambda t: pf.run(
        t, params, cfg, key=key, scheme="systematic", pmesh=pm))(tl)
    np.testing.assert_array_equal(np.asarray(f_sh.particles), np.asarray(f_ref.particles))
    np.testing.assert_allclose(np.asarray(o_sh["mean"]), np.asarray(o_ref["mean"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(o_sh["cov"]), np.asarray(o_ref["cov"]),
                               rtol=1e-4, atol=1e-4)


def _numpy_systematic(w, u):
    """float64 systematic resample: slot j takes the first ancestor whose
    cumulative weight exceeds (j + u) / N."""
    cdf = np.cumsum(w.astype(np.float64))
    cdf /= cdf[-1]
    pos = (np.arange(len(w)) + u) / len(w)
    return np.minimum(np.searchsorted(cdf, pos, side="right"), len(w) - 1), cdf, pos


def _assert_ancestors_match(w, key):
    w = jnp.asarray(w, jnp.float32)
    u = float(jax.random.uniform(key, (), jnp.float32))
    anc = np.asarray(jax.jit(resampling.systematic_resample)(key, w))
    ref, cdf64, pos = _numpy_systematic(np.asarray(w), u)
    cdf32 = np.asarray(resampling.blocked_cdf(w), np.float64)
    tie_tol = np.abs(cdf32 - cdf64).max() + 2.0 ** -23
    assert np.all(np.diff(anc) >= 0)
    for j in np.nonzero(anc != ref)[0]:
        lo, hi = sorted((int(anc[j]), int(ref[j])))
        assert np.abs(cdf64[lo:hi] - pos[j]).max() <= tie_tol, (j, anc[j], ref[j])
    return anc, ref


@pytest.mark.parametrize("n", [1000, 4096, (1 << 14) + 3, 1 << 17])
def test_systematic_ancestors_match_float64(n):
    rng = np.random.default_rng(n)
    w = rng.exponential(1.0, n) ** 2
    _assert_ancestors_match(w / w.sum(), jax.random.PRNGKey(n))


@pytest.mark.parametrize("kind", ["spike", "two_spikes", "zero_tail", "uniform"])
def test_systematic_ancestors_degenerate_weights(kind):
    n = 1 << 13
    w = np.full(n, 1e-30)
    if kind == "spike":
        w[1234] = 1.0
    elif kind == "two_spikes":
        w[10], w[n - 5] = 0.25, 0.75
    elif kind == "zero_tail":
        w[: n // 2] = 1.0
    else:
        w[:] = 1.0
    anc, ref = _assert_ancestors_match(w / w.sum(), jax.random.PRNGKey(7))
    if kind == "spike":
        assert np.all(anc == 1234)
    elif kind == "two_spikes":
        assert set(np.unique(anc)) == {10, n - 5}
        assert abs((anc == 10).mean() - 0.25) <= 1.0 / n
    elif kind == "zero_tail":
        assert anc.max() < n // 2
    else:
        np.testing.assert_array_equal(anc, np.arange(n))

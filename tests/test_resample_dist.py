"""Distributed systematic resample (explicit collectives over the particle
axis) vs the single-device sampler: bit-identical ancestors.

The exactness hinges on the shared blocked-CDF summation tree
(``ops.resampling.blocked_cdf``): computed per-shard + all-gathered block
sums must reproduce the full-bank f32 roundings element for element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smarc_navigation_tpu.ops import resampling
from smarc_navigation_tpu.parallel import mesh as pmesh
from smarc_navigation_tpu.parallel import resample_dist


def _bank(n, seed=0):
    rng = np.random.default_rng(seed)
    parts = rng.normal(size=(6, n)).astype(np.float32)
    return jnp.asarray(parts)


def _weights(n, kind, seed=0):
    rng = np.random.default_rng(seed + 17)
    if kind == "uniform":
        w = rng.uniform(0.5, 1.5, n)
    elif kind == "skewed":
        w = rng.exponential(1.0, n) ** 2
    elif kind == "collapse":
        w = np.full(n, 1e-12)
        w[n // 3] = 1.0
    else:
        raise ValueError(kind)
    w = (w / w.sum()).astype(np.float32)
    return jnp.asarray(w)


def test_blocked_cdf_matches_plain_cumsum_tolerance():
    n = 4 * resampling.CDF_BLOCK
    w = _weights(n, "uniform")
    np.testing.assert_allclose(
        np.asarray(resampling.blocked_cdf(w)),
        np.cumsum(np.asarray(w)), rtol=1e-5)


@pytest.mark.parametrize("kind", ["uniform", "skewed", "collapse"])
@pytest.mark.parametrize("particle_ax", [4, 8])
def test_dist_resample_bit_identical_ancestors(kind, particle_ax):
    n = 1 << 17
    m = pmesh.make_mesh(particle=particle_ax)
    parts = _bank(n)
    w = _weights(n, kind)
    key = jax.random.PRNGKey(7)

    # single-device reference: ancestors of the XLA sampler
    anc = resampling.systematic_resample(key, w)
    ref = np.asarray(jnp.take(parts, anc, axis=1))

    out = resample_dist.systematic_resample_gather_dist(
        parts, w, key, m, halo=2048)
    np.testing.assert_array_equal(np.asarray(out), ref)


def test_dist_resample_fallback_on_tiny_halo():
    """A halo too small for the ancestor spread must route to the exact
    all-gather branch, not return wrong columns."""
    n = 1 << 17
    m = pmesh.make_mesh(particle=8)
    parts = _bank(n, seed=3)
    # all mass on the middle shard: every shard's ancestors live there
    w = _weights(n, "collapse", seed=3)
    key = jax.random.PRNGKey(11)
    anc = resampling.systematic_resample(key, w)
    ref = np.asarray(jnp.take(parts, anc, axis=1))
    out = resample_dist.systematic_resample_gather_dist(
        parts, w, key, m, halo=128)
    np.testing.assert_array_equal(np.asarray(out), ref)


def test_expand_gather_offset_window_matches():
    """The shard-local expansion (``resample_dist.expand_window``) with a
    nonzero output offset over a halo-extended window — exactly the arrays
    ``systematic_gather_shard`` hands it, built here in numpy per shard —
    matches the ancestors of the single-device sampler."""
    n = 1 << 14
    P_, H = 4, 1024
    ns = n // P_
    parts = _bank(n, seed=5)
    w = _weights(n, "uniform", seed=5)
    key = jax.random.PRNGKey(3)
    u = jax.random.uniform(key, (), jnp.float32)
    m_cum = np.asarray(resampling.systematic_counts(w, u))
    anc = resampling.systematic_resample(key, w)
    ref = np.asarray(jnp.take(parts, anc, axis=1))

    parts_np = np.asarray(parts)
    for s in range(P_):
        lo, hi = s * ns, (s + 1) * ns
        xlo, xhi = max(0, lo - H), min(n, hi + H)
        # build extended window exactly as the shard body would: zero-fill
        # halos that fall off the bank (shard 0 left, last shard right=n)
        m_ext = np.zeros(ns + 2 * H, np.int32)
        p_ext = np.zeros((6, ns + 2 * H), np.float32)
        m_ext[H - (lo - xlo):H] = m_cum[xlo:lo]
        m_ext[H:H + ns] = m_cum[lo:hi]
        m_ext[H + ns:H + ns + (xhi - hi)] = m_cum[hi:xhi]
        if s == P_ - 1:
            m_ext[H + ns:] = n
        p_ext[:, H - (lo - xlo):H] = parts_np[:, xlo:lo]
        p_ext[:, H:H + ns] = parts_np[:, lo:hi]
        p_ext[:, H + ns:H + ns + (xhi - hi)] = parts_np[:, hi:xhi]

        out = resample_dist.expand_window(
            jnp.asarray(m_ext), jnp.asarray(p_ext), jnp.int32(lo), ns)
        np.testing.assert_array_equal(np.asarray(out), ref[:, lo:hi])


def test_tree_sum_shard_bitwise_on_mesh():
    """``tree_sum_shard`` inside shard_map over the particle axis must
    reproduce the unsharded ``tree_sum`` BITWISE (the per-row dot sums are
    shard-local for CDF_BLOCK-tiling shards; the cross-row fold runs
    redundantly on the gathered row sums) — this is the mechanism behind
    the fast path's shard-invariant weights. Covers power-of-two AND
    non-power-of-two (3*2048) shard widths."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from smarc_navigation_tpu.parallel.mesh import PARTICLE_AXIS

    pm = pmesh.make_mesh(mission=2, particle=4)
    for n in (1 << 14, 4 * 3 * 2048):  # pow2 shards / non-pow2 fallback
        x = jnp.asarray(
            np.random.default_rng(3).exponential(1.0, n).astype(np.float32))
        ref = resampling.tree_sum(x)
        got = shard_map(
            lambda v: resampling.tree_sum_shard(v[:, 0], PARTICLE_AXIS)[None],
            mesh=pm, in_specs=P(PARTICLE_AXIS, None), out_specs=P(),
            check_vma=False,
        )(x[:, None])
        np.testing.assert_array_equal(np.asarray(got)[0], np.asarray(ref))


def test_normalize_weights_det_shard_bitwise_on_mesh():
    """``normalize_weights_det_shard`` under shard_map == the unsharded
    ``normalize_weights_det``, element-bitwise, for healthy and skewed
    log-weights (r05: the fast shard body derives its weights this way, so
    ancestors — hence banks — are shard-count-invariant)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from smarc_navigation_tpu.parallel.mesh import PARTICLE_AXIS

    pm = pmesh.make_mesh(mission=2, particle=4)
    n = 1 << 14
    rng = np.random.default_rng(11)
    for scale in (1.0, 50.0):
        logw = jnp.asarray((-scale * rng.exponential(1.0, n))
                           .astype(np.float32))
        ref = resampling.normalize_weights_det(logw)
        got = shard_map(
            lambda v: resampling.normalize_weights_det_shard(
                v, PARTICLE_AXIS),
            mesh=pm, in_specs=P(PARTICLE_AXIS), out_specs=P(PARTICLE_AXIS),
            check_vma=False,
        )(logw)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))

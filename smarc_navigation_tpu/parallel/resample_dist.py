"""Distributed systematic resample for a particle bank sharded across chips.

The reference resamples a 50-particle bank in a python loop
(``auv_particle_filter/scripts/resampling.py:135-168``); the single-chip
rebuild is ``ops.resampling.systematic_resample``. This module is the
multi-device form: the (6, N) bank lives sharded over the mesh's
``particle`` axis and the resample runs with EXPLICIT collectives —
nothing here relies on GSPMD re-gathering the bank.

Design (per shard, inside ``shard_map``):

1. **Global CDF from shard-local prefix sums.** Each shard cumsums its
   CDF_BLOCK rows, all-gathers the tiny per-block sums (N/2048 floats) and
   rebuilds its slice of the global blocked CDF. Because the single-device
   path uses the *same* two-level summation tree
   (``ops.resampling.blocked_cdf``), the f32 roundings coincide and the
   derived ancestor counts are **bit-identical** to the single-device
   kernel — not approximately equal.
2. **Global monotone counts.** Local ``cummax`` + an exclusive prefix-max
   carry of the shard-last values (one more tiny all-gather).
3. **Halo exchange.** Systematic ancestors are monotone, so the ancestors
   of a shard's output slots form a contiguous global window near the
   shard's own range. Two ``ppermute``s pull a fixed halo of H particles
   (and their counts) from each neighbour; the expansion (searchsorted +
   take over the halo-extended window) then runs fully locally.
4. **Exact fallback.** Under extreme weight imbalance the ancestor window
   can exceed the halo; a psum'd fit flag routes ALL shards to an
   all-gather + exact gather. In a running filter this happens at most at
   a weight-collapse fix, never in steady state.

The added collectives per resample are two small all-gathers (N/2048 block
sums and P shard-last counts) and four H-column ppermutes to the
neighbouring devices.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import resampling

from .mesh import MISSION_AXIS, PARTICLE_AXIS


def _ppermute_from_left(x, axis_name, P_):
    """Each shard receives its LEFT neighbour's value (shard 0 gets zeros)."""
    return jax.lax.ppermute(x, axis_name, [(i, i + 1) for i in range(P_ - 1)])


def _ppermute_from_right(x, axis_name, P_):
    """Each shard receives its RIGHT neighbour's value (last shard: zeros)."""
    return jax.lax.ppermute(x, axis_name, [(i + 1, i) for i in range(P_ - 1)])


def systematic_gather_shard(
    parts: jnp.ndarray,    # (6, Ns) local bank columns
    weights: jnp.ndarray,  # (Ns,) local slice of GLOBALLY normalized weights
    key,                   # identical on every shard
    axis_name: str = PARTICLE_AXIS,
    halo: int = 4096,
) -> jnp.ndarray:
    """Shard body of the distributed systematic resample (call inside
    ``shard_map`` over the particle axis). Returns the shard's (6, Ns)
    resampled columns; the concatenation over shards is bit-identical to
    ``resampling.systematic_resample`` ancestors applied to the full bank.

    Requirements: Ns divisible by ``resampling.CDF_BLOCK``; ``halo`` a
    multiple of 128 with halo <= Ns.
    """
    P_ = jax.lax.axis_size(axis_name)
    s = jax.lax.axis_index(axis_name)
    ns = parts.shape[1]
    n = ns * P_
    H = halo
    if ns % resampling.CDF_BLOCK or H % 128 or H > ns:
        raise ValueError(f"shard size {ns} / halo {H} violate tiling")
    f32 = jnp.float32
    is_last = s == P_ - 1

    # --- 1. global blocked CDF (bit-identical to blocked_cdf(full)) -------
    rows = weights.astype(f32).reshape(ns // resampling.CDF_BLOCK,
                                       resampling.CDF_BLOCK)
    rowcum = jnp.cumsum(rows, axis=1)
    bs_all = jax.lax.all_gather(rowcum[:, -1], axis_name, tiled=True)
    prefix_all = jnp.concatenate(
        [jnp.zeros(1, f32), jnp.cumsum(bs_all)[:-1]])
    prefix_loc = jax.lax.dynamic_slice(
        prefix_all, (s * rows.shape[0],), (rows.shape[0],))
    cdf = (rowcum + prefix_loc[:, None]).reshape(ns)
    cdf = cdf.at[-1].set(jnp.where(is_last, 1.0, cdf[-1]))  # round-off guard

    # --- 2. global monotone counts ----------------------------------------
    u = jax.random.uniform(key, (), f32)
    m = jnp.clip(jnp.ceil(n * cdf - u), 0, n).astype(jnp.int32)
    m = jax.lax.cummax(m)
    last_all = jax.lax.all_gather(m[-1], axis_name)          # (P,)
    prev_max = jnp.max(
        jnp.where(jnp.arange(P_) < s, last_all, 0), initial=0)
    m = jnp.maximum(m, prev_max)                             # == global cummax

    # --- 3. halo exchange --------------------------------------------------
    m_left = _ppermute_from_left(m[-H:], axis_name, P_)      # shard 0: zeros
    m_right = _ppermute_from_right(m[:H], axis_name, P_)
    m_right = jnp.where(is_last, n, m_right)                 # keep monotone
    p_left = _ppermute_from_left(parts[:, -H:], axis_name, P_)
    p_right = _ppermute_from_right(parts[:, :H], axis_name, P_)
    m_ext = jnp.concatenate([m_left, m, m_right])            # (Ns + 2H,)
    parts_ext = jnp.concatenate([p_left, parts, p_right], axis=1)

    # --- 4. fit check (global) --------------------------------------------
    # this shard's outputs are global slots [s·Ns, (s+1)·Ns); their
    # ancestors must sit inside the extended window [0, Ns + 2H): the
    # window's first count must not already exceed g0 (left), and the last
    # output slot's ancestor must be found in-window (right)
    g0 = s * ns
    ts_last = jnp.searchsorted(
        m_ext, g0 + ns - 1, side="right").astype(jnp.int32)
    fits_local = (m_ext[0] <= g0) & (ts_last < ns + 2 * H)
    fits = jax.lax.psum(fits_local.astype(jnp.int32), axis_name) == P_

    def fast(_):
        return expand_window(m_ext, parts_ext, g0, ns)

    def exact(_):
        # all-gather the bank (weight-collapse rarity): m carries the global
        # cummax already, so concatenation over shards == global m_cum.
        # Ancestors via scatter+cummax (``_expand_blocks``) — same ancestors
        # as searchsorted side="right" by definition
        m_full = jax.lax.all_gather(m, axis_name, tiled=True)
        p_full = jax.lax.all_gather(parts, axis_name, axis=1, tiled=True)
        anc = jax.lax.dynamic_slice(
            resampling._expand_blocks(m_full), (g0,), (ns,))
        return jnp.take(p_full, anc, axis=1)

    return jax.lax.cond(fits, fast, exact, None)


def expand_window(m_ext: jnp.ndarray, parts_ext: jnp.ndarray, g0,
                  ns: int) -> jnp.ndarray:
    """Columns of output slots [g0, g0 + ns) from a halo-extended window:
    slot j belongs to the first window particle whose cumulative count
    ``m_ext`` exceeds j (systematic ancestors are monotone)."""
    anc = jnp.searchsorted(
        m_ext, g0 + jnp.arange(ns, dtype=jnp.int32), side="right")
    return jnp.take(parts_ext, jnp.clip(anc, 0, m_ext.shape[0] - 1), axis=1)


def _clamped_halo(halo: int, ns: int) -> int:
    """Halo capped to the shard width (small banks) on a 128 multiple."""
    return min(halo, (ns // 128) * 128)


def systematic_resample_gather_dist(
    parts: jnp.ndarray,    # (6, N) global bank (sharded or to-be-sharded)
    weights: jnp.ndarray,  # (N,) globally normalized
    key,
    pmesh: Mesh,
    halo: int = 4096,
) -> jnp.ndarray:
    """Mesh-level entry: shard_map ``systematic_gather_shard`` over the
    ``particle`` axis of ``pmesh``. Ancestors are bit-identical to the
    single-device ``resampling.systematic_resample`` under the same key."""
    from jax import shard_map

    ns = parts.shape[1] // pmesh.shape[PARTICLE_AXIS]
    body = functools.partial(
        systematic_gather_shard,
        axis_name=PARTICLE_AXIS, halo=_clamped_halo(halo, ns))
    spec_b = P(None, PARTICLE_AXIS)
    spec_w = P(PARTICLE_AXIS)
    fn = shard_map(
        body, mesh=pmesh,
        in_specs=(spec_b, spec_w, P()),
        out_specs=spec_b,
        check_vma=False,
    )
    return fn(parts, weights, key)


def systematic_resample_gather_dist_batched(
    parts: jnp.ndarray,    # (B, 6, N) fleet banks
    weights: jnp.ndarray,  # (B, N) per-mission globally normalized
    keys,                  # (B, ...) per-mission keys
    pmesh: Mesh,
    halo: int = 4096,
) -> jnp.ndarray:
    """Fleet form: one shard_map over BOTH mesh axes — missions shard over
    ``mission``, each mission's bank columns over ``particle`` — with the
    shard body vmapped over its local missions. Keeps every collective
    local to the particle axis (no cross-mission gathers), unlike wrapping
    the single-mission entry in ``jax.vmap`` (whose batching rule treats
    the mesh's mission axis as replicated and GSPMD re-gathers the fleet).

    Per mission, ancestors are bit-identical to the single-device
    ``resampling.systematic_resample`` under the same key."""
    from jax import shard_map

    M = pmesh.shape[MISSION_AXIS]
    if parts.shape[0] % M:
        raise ValueError(
            f"fleet size {parts.shape[0]} not divisible by mission axis {M}")
    ns = parts.shape[2] // pmesh.shape[PARTICLE_AXIS]

    def body(p_b, w_b, k_b):
        return jax.vmap(
            functools.partial(
                systematic_gather_shard,
                axis_name=PARTICLE_AXIS, halo=_clamped_halo(halo, ns))
        )(p_b, w_b, k_b)

    fn = shard_map(
        body, mesh=pmesh,
        in_specs=(P(MISSION_AXIS, None, PARTICLE_AXIS),
                  P(MISSION_AXIS, PARTICLE_AXIS),
                  P(MISSION_AXIS)),
        out_specs=P(MISSION_AXIS, None, PARTICLE_AXIS),
        check_vma=False,
    )
    return fn(parts, weights, keys)

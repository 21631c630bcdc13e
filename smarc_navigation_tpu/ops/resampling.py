"""Particle resampling schemes, on-device.

Re-implementations of the four FilterPy-style samplers the reference vendors
(``auv_particle_filter/scripts/resampling.py:27-194``), reformulated for
XLA: no data-dependent python loops — every scheme is cumsum + searchsorted
with static shapes, so they jit, vmap over mission fleets, and run on device.

All samplers take normalized weights (N,) and a PRNG key and return (N,)
int32 ancestor indices.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Block size of the deterministic prefix-sum used for systematic counts.
# The blocked form makes the f32 rounding of the CDF INDEPENDENT of how the
# bank is laid out: computed over the full bank or per particle-shard
# (shard sizes a multiple of the block), every element sees the same
# summation tree — which is what lets the distributed resample
# (``parallel.resample_dist``) produce bit-identical ancestors to the
# single-device path.
CDF_BLOCK = 2048


def blocked_cdf(weights: jnp.ndarray) -> jnp.ndarray:
    """Prefix sum with a fixed two-level summation tree (intra-block scan +
    scan of block sums). Falls back to a plain cumsum for banks that don't
    tile by CDF_BLOCK (small banks; the distributed path requires tiling)."""
    n = weights.shape[0]
    if n % CDF_BLOCK or n <= CDF_BLOCK:
        return jnp.cumsum(weights)
    rows = weights.reshape(n // CDF_BLOCK, CDF_BLOCK)
    rowcum = jnp.cumsum(rows, axis=1)
    prefix = jnp.concatenate(
        [jnp.zeros(1, weights.dtype), jnp.cumsum(rowcum[:, -1])[:-1]])
    return (rowcum + prefix[:, None]).reshape(n)


def _fold_half(x: jnp.ndarray) -> jnp.ndarray:
    """Radix-2 fold-in-half sum of a small 1-D vector (zero-padded to a
    power of two). Contiguous halves only — every addition is an
    elementwise op whose operands are pinned by the program DAG, so the
    f32 result is bit-identical under ANY sharding/layout."""
    n = x.shape[0]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        x = jnp.concatenate([x, jnp.zeros((p - n,), x.dtype)])
    while p > 1:
        p //= 2
        x = x[:p] + x[p:]
    return x[0]


def _row_fold(y: jnp.ndarray) -> jnp.ndarray:
    """Per-row fold-in-half sums of a 2-D (rows, CDF_BLOCK) view — the
    shard-local half of ``tree_sum``'s pinned order. Elementwise only."""
    c = y.shape[1]
    while c > 1:
        c //= 2
        y = y[:, :c] + y[:, c:]
    return y[:, 0]


def tree_sum(x: jnp.ndarray) -> jnp.ndarray:
    """Bit-deterministic sum of a 1-D vector, pinned to a fixed two-level
    fold-in-half order: within CDF_BLOCK-wide rows, then across the row
    sums. Unlike ``jnp.sum``, whose reduction GSPMD legally reassociates
    into local-reduce + all-reduce (measured: one-ulp weight drift flips
    systematic-resample ancestors at stratum boundaries, ~0.02%/update at
    2^14), every addition here is an ELEMENTWISE op whose operands are
    pinned by the program DAG — IEEE scalar semantics make the result
    bit-identical under any layout, fusion, sharding, or backend, and the
    two-level structure makes it decomposable over contiguous shards whose
    width tiles by CDF_BLOCK: rows never cross a shard boundary, so
    ``tree_sum_shard`` rebuilds the global value from a 2 KB row-sum
    all-gather.

    Formulation notes: a ``(R,2048) @ ones`` row dot would also be
    shard-local, but its K-accumulation order is compiler-internal (eager
    vs jit on CPU differ by 1 ulp even behind an optimization_barrier) —
    not a sound basis for a bitwise claim; the contiguous fold-in-half form
    is pinned by IEEE semantics. Vectors that don't tile by CDF_BLOCK fold
    directly (small banks; the distributed paths require tiling anyway)."""
    n = x.shape[0]
    if n % CDF_BLOCK or n <= CDF_BLOCK:
        return _fold_half(x)
    return _fold_half(_row_fold(x.reshape(n // CDF_BLOCK, CDF_BLOCK)))


def tree_sum_shard(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Global ``tree_sum`` of a contiguously sharded vector, from inside
    ``shard_map``: shard-local per-row folds + an all-gather of the row
    sums (2 KB at 2^20) + the same fold-in-half every shard computes
    redundantly. Bitwise equal to ``tree_sum(concat(shards))`` whenever
    the local length tiles by CDF_BLOCK — rows never cross a contiguous
    shard boundary and the gathered row-sum vector is exactly the
    unsharded one (any shard count, power of two or not). Non-tiling
    shards fall back to gathering the full vector — same value, more
    bytes."""
    ns = x.shape[0]
    if ns % CDF_BLOCK:
        return tree_sum(jax.lax.all_gather(x, axis_name, tiled=True))
    rows = _row_fold(x.reshape(ns // CDF_BLOCK, CDF_BLOCK))
    return _fold_half(jax.lax.all_gather(rows, axis_name, tiled=True))


def normalize_weights_det(logw: jnp.ndarray) -> jnp.ndarray:
    """Layout-invariant weight normalization: exp(logw − max) + floor,
    scaled by ONE ``tree_sum`` — the reference's add-floor-then-renormalize
    (``auv_pf.py:163-166`` adds 1e-200 to the raw pdf weights then divides
    by the sum; 1e-30 here — f32). The max subtraction already pins
    max(e) == 1, so the floor's relative scale matches the reference's.
    ``jnp.max`` is exactly associative, the tree sum is order-pinned, and
    the elementwise tail is layout-independent — so a sharded bank produces
    bitwise the same weights (hence the same ancestors) as the
    single-device program."""
    m = jnp.max(logw)
    w = jnp.exp(logw - m) + 1e-30
    return w / tree_sum(w)


def normalize_weights_det_shard(logw: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Shard body of ``normalize_weights_det`` (call inside ``shard_map``
    over a contiguously particle-sharded bank): ``pmax`` is exactly
    associative and the tree sum routes through ``tree_sum_shard``, so the
    returned local weight slice is BITWISE the corresponding slice of the
    unsharded ``normalize_weights_det`` — at any shard count."""
    m = jax.lax.pmax(jnp.max(logw), axis_name)
    w = jnp.exp(logw - m) + 1e-30
    return w / tree_sum_shard(w, axis_name)


def systematic_counts(weights: jnp.ndarray, u) -> jnp.ndarray:
    """Monotone cumulative ancestor counts m_cum[i] = #outputs owned by
    ancestors 0..i (ints ending at N): cummax(clip(ceil(N·cdf − u))).
    Shared by the single-device sampler and the distributed resample so
    their ancestors agree bit-for-bit."""
    n = weights.shape[0]
    cdf = blocked_cdf(weights)
    cdf = cdf.at[-1].set(1.0)  # guard round-off (reference does the same)
    m_cum = jnp.clip(jnp.ceil(n * cdf - u), 0, n).astype(jnp.int32)
    # XLA's parallel cumsum is not monotone under f32 rounding (segment
    # boundaries can step back by an ulp, which survives the ceil at large
    # N); a true prefix sum of positive weights is — restore that invariant.
    #
    # The repair is EXACTLY the global lax.cummax, computed blockwise:
    # cummax within each CDF_BLOCK row, then a cross-block carry max. Equality with the global cummax: blocked_cdf's value at a block
    # start is w ⊕ (prefixᵢ ⊕ rowsumᵢ) ≥ rowsumᵢ ⊕ prefixᵢ (f32 addition
    # is monotone for w ≥ 0 and commutative), so raw v can only step DOWN
    # within a row — and the carry max re-applies each previous row's
    # maximum, which is all the global running max could have carried.
    if n % CDF_BLOCK or n <= CDF_BLOCK:
        return jax.lax.cummax(m_cum)
    rows = m_cum.reshape(n // CDF_BLOCK, CDF_BLOCK)
    rows = jax.lax.cummax(rows, axis=1)
    carry = jax.lax.cummax(rows[:, -1])
    prev = jnp.concatenate(
        [jnp.full((1,), jnp.iinfo(jnp.int32).min, jnp.int32), carry[:-1]])
    return jnp.maximum(rows, prev[:, None]).reshape(n)


def _inverse_cdf(weights: jnp.ndarray, positions: jnp.ndarray) -> jnp.ndarray:
    cdf = jnp.cumsum(weights)
    cdf = cdf.at[-1].set(1.0)  # guard round-off (reference does the same)
    # method="sort": one sort-based lookup instead of the default binary
    # search's ~log2(N) rounds of N-wide random gathers.
    return jnp.searchsorted(cdf, positions, method="sort").astype(jnp.int32)


def _expand_blocks(m_cum: jnp.ndarray) -> jnp.ndarray:
    """Ancestor indices from a monotone count vector.

    m_cum[i] = number of output slots owned by ancestors 0..i (ints, ending
    at N). Returns (N,) ancestors: slot j belongs to the smallest i with
    m_cum[i] > j. Sort-free: scatter each block's index at its start slot,
    then a running max — O(N) work instead of a sort.
    """
    n = m_cum.shape[0]
    starts = jnp.concatenate([jnp.zeros(1, m_cum.dtype), m_cum[:-1]])
    counts = m_cum - starts
    ids = jnp.arange(n, dtype=jnp.int32)
    marks = jnp.full(n, -1, jnp.int32)
    marks = marks.at[starts].max(jnp.where(counts > 0, ids, -1), mode="drop")
    return jax.lax.cummax(marks)


def systematic_resample(key, weights: jnp.ndarray) -> jnp.ndarray:
    """One random offset, N evenly spaced positions
    (``resampling.py:135-168``).

    With the evenly spaced position grid p_j=(j+u)/N the inverse CDF has a
    closed-form count per ancestor — ⌈N·cdf_i − u⌉ — so the whole resample
    is cumsum + scatter + running-max (no sort, no binary search).
    """
    u = jax.random.uniform(key, (), weights.dtype)
    return _expand_blocks(systematic_counts(weights, u))


def stratified_resample(key, weights: jnp.ndarray) -> jnp.ndarray:
    """One uniform draw per stratum (``resampling.py:80-114``)."""
    n = weights.shape[0]
    u = jax.random.uniform(key, (n,))
    positions = (u + jnp.arange(n, dtype=weights.dtype)) / n
    return _inverse_cdf(weights, positions)


def multinomial_resample(key, weights: jnp.ndarray) -> jnp.ndarray:
    """IID draws from the weight distribution (``resampling.py:171-194``,
    'naive' variant included — same estimator; the reference sorts its
    uniforms first, which only permutes slot order, so we skip the sort)."""
    n = weights.shape[0]
    u = jax.random.uniform(key, (n,))
    return _inverse_cdf(weights, u)


def residual_resample(key, weights: jnp.ndarray) -> jnp.ndarray:
    """Deterministic ⌊N·w⌋ copies + multinomial on the residual
    (``resampling.py:27-76``).

    The reference's python loop materializes each particle's copies in
    sequence; here the deterministic block is an inverse-CDF over the copy
    counts (identical multiset of ancestors) and the stochastic tail is a
    multinomial over the residual weights — distribution-identical, fixed
    shape.
    """
    n = weights.shape[0]
    scaled = n * weights
    copies = jnp.floor(scaled)
    k = jnp.sum(copies).astype(jnp.int32)  # deterministic count (dynamic value)

    # deterministic ancestors: block expansion of the integer copy counts
    cum = jnp.cumsum(copies).astype(jnp.int32)
    det_idx = jnp.clip(_expand_blocks(cum), 0, n - 1)

    # stochastic tail from residual weights
    resid = scaled - copies
    resid_sum = jnp.maximum(jnp.sum(resid), 1e-30)
    resid = resid / resid_sum
    u = jax.random.uniform(key, (n,))
    tail_idx = _inverse_cdf(resid, u)

    # slots [0,k) deterministic, [k,N) stochastic — static shapes via where
    take_det = jnp.arange(n) < k
    # tail slot j>=k uses tail draw (j-k); gather with shifted index
    shift = jnp.clip(jnp.arange(n) - k, 0, n - 1)
    return jnp.where(take_det, det_idx, tail_idx[shift])


SCHEMES = {
    "systematic": systematic_resample,
    "stratified": stratified_resample,
    "multinomial": multinomial_resample,
    "residual": residual_resample,
}

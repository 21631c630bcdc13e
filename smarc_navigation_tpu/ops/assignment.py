"""Linear assignment for SLAM data association.

The reference solves the (landmarks+candidates) × measurements Mahalanobis
cost table with a vendored Munkres/Hungarian solver on the host
(``ekf_slam_core.cpp:283-304``, ``auv_ekf_slam/utils/munkres/``). Here:

* ``hungarian`` — exact Jonker-Volgenant shortest-augmenting-path Hungarian
  implemented in pure JAX: fully jittable (``fori``/``while_loop`` with
  static bounds), vmappable over mission fleets, runs inside the scanned
  filter step on device. For C columns × R rows (C ≤ R; every measurement
  always has its own new-landmark candidate row) the work is O(C·R) vector
  steps.

* ``hungarian_host`` — the same optimum via ``jax.pure_callback`` to scipy's
  JV (cross-check / fidelity path; also used by the numpy oracles).

A note on an abandoned design: a Bertsekas forward auction was tried first
(the SURVEY §7 plan) but plain forward auction is not optimal for
*asymmetric* problems — rows left unassigned can retain stale inflated
prices that block the true optimum — and the textbook fix (reverse-auction
phases) costs more than exact JV at these sizes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_INF = 1e30


@jax.jit
def hungarian(cost: jnp.ndarray) -> jnp.ndarray:
    """Exact min-cost assignment of every column to a distinct row.

    cost: (R, C) with C <= R. Returns col_to_row (C,) int32.

    Jonker-Volgenant with dual potentials (u over columns, v over rows) and
    Dijkstra-style shortest augmenting paths; the classic O(C²·R) dense
    formulation with a virtual start row at index R.
    """
    R, C = cost.shape
    if C > R:
        raise ValueError("hungarian requires C <= R (pad candidate rows)")
    dtype = cost.dtype
    inf = jnp.asarray(_INF, dtype)

    # p[j]: column assigned to row j (-1 free); index R is the virtual root.
    def solve_col(c, carry):
        u, v, p = carry  # u: (C,), v: (R+1,), p: (R+1,)
        p = p.at[R].set(c)

        minv0 = jnp.full(R + 1, inf, dtype).at[R].set(-inf)  # root always "used"
        way0 = jnp.full(R + 1, R, jnp.int32)
        used0 = jnp.zeros(R + 1, bool).at[R].set(True)

        def cond(s):
            j0, used, minv, way, u, v, done = s
            return ~done

        def body(s):
            j0, used, minv, way, u, v, done = s
            i0 = p[j0]                       # column occupying current row
            u_i0 = jnp.where(i0 >= 0, u[jnp.maximum(i0, 0)], 0.0)
            cur = cost[:, jnp.maximum(i0, 0)] - u_i0 - v[:R]   # (R,)
            cur = jnp.where(i0 >= 0, cur, inf)
            better = (cur < minv[:R]) & (~used[:R])
            minv = minv.at[:R].set(jnp.where(better, cur, minv[:R]))
            way = way.at[:R].set(jnp.where(better, j0, way[:R]))

            masked = jnp.where(used[:R], inf, minv[:R])
            j1 = jnp.argmin(masked).astype(jnp.int32)
            delta = masked[j1]

            # dual update: every used row's assigned column gains delta,
            # used rows' potentials drop, unused slacks shrink
            gain = jnp.zeros(C, dtype)
            upd_mask = used & (p >= 0)
            gain = gain.at[jnp.maximum(p, 0)].add(jnp.where(upd_mask, delta, 0.0))
            u = u + gain
            v = v - jnp.where(used, delta, 0.0)
            minv = jnp.where(used, minv, minv - delta)

            used = used.at[j1].set(True)
            done = p[j1] < 0  # reached a free row
            return j1, used, minv, way, u, v, done

        j0, used, minv, way, u, v, _ = jax.lax.while_loop(
            cond, body, (jnp.asarray(R, jnp.int32), used0, minv0, way0, u, v,
                         jnp.asarray(False))
        )

        # augment: walk predecessor chain back to the virtual root
        def aug_cond(s):
            j, p = s
            return j != R

        def aug_body(s):
            j, p = s
            j1 = way[j]
            p = p.at[j].set(p[j1])
            return j1, p

        _, p = jax.lax.while_loop(aug_cond, aug_body, (j0, p))
        p = p.at[R].set(-1)
        return u, v, p

    u0 = jnp.zeros(C, dtype)
    v0 = jnp.zeros(R + 1, dtype)
    p0 = jnp.full(R + 1, -1, jnp.int32)
    _, _, p = jax.lax.fori_loop(0, C, solve_col, (u0, v0, p0))

    rows = jnp.arange(R, dtype=jnp.int32)
    col_to_row = jnp.full(C, -1, jnp.int32).at[
        jnp.where(p[:R] >= 0, p[:R], C)  # unassigned rows write out of bounds
    ].set(rows, mode="drop")
    return col_to_row


def _scipy_solve(cost: np.ndarray) -> np.ndarray:
    from scipy.optimize import linear_sum_assignment

    rows, cols = linear_sum_assignment(cost)
    out = np.full(cost.shape[1], -1, np.int32)
    out[cols] = rows.astype(np.int32)
    return out


def _host_solve(cost: np.ndarray) -> np.ndarray:
    """Native C++ JV when built (the Munkres-solver slot of the reference),
    scipy otherwise."""
    from .. import native

    if native.available():
        return native.jv_assign(cost)
    return _scipy_solve(cost)


def hungarian_host(cost: jnp.ndarray) -> jnp.ndarray:
    """Exact assignment on the host via pure_callback (fidelity/oracle path).

    Each call round-trips the cost table to the host, so the fleet paths
    use the device ``hungarian`` (same optimum, same algorithm)."""
    C = cost.shape[-1]
    return jax.pure_callback(
        lambda c: _host_solve(np.asarray(c, np.float64)),
        jax.ShapeDtypeStruct((C,), jnp.int32),
        cost,
        vmap_method="sequential",
    )


def assignment_cost(cost: jnp.ndarray, col_to_row: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(cost[col_to_row, jnp.arange(cost.shape[1])])

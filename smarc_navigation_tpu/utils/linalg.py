"""Small-matrix linear algebra for filters.

Replaces the reference's boost::ublas LU helpers
(``auv_ekf_localization/include/utils_matrices/utils_matrices.hpp:35-67``)
with Cholesky-factored solves — better conditioned for the SPD innovation
matrices the filters actually invert, and free of pivoting and
data-dependent control flow.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def symmetrize(a: jnp.ndarray) -> jnp.ndarray:
    """0.5 (A + Aᵀ) over the trailing two dims. Keeps covariances symmetric
    under f32 round-off (the C++ reference relies on exact arithmetic order
    instead)."""
    return 0.5 * (a + jnp.swapaxes(a, -1, -2))


def spd_solve(S: jnp.ndarray, b: jnp.ndarray, jitter: float = 0.0) -> jnp.ndarray:
    """Solve S x = b for SPD S (..., n, n) against b (..., n) or (..., n, k)."""
    if jitter:
        S = S + jitter * jnp.eye(S.shape[-1], dtype=S.dtype)
    chol = jnp.linalg.cholesky(symmetrize(S))
    return jax.scipy.linalg.cho_solve((chol, True), b)


def spd_inverse(S: jnp.ndarray, jitter: float = 0.0) -> jnp.ndarray:
    """Explicit SPD inverse via Cholesky (needed where the reference stores
    S⁻¹, e.g. ``correspondence_obj.cpp:80-97``)."""
    eye = jnp.eye(S.shape[-1], dtype=S.dtype)
    return spd_solve(S, jnp.broadcast_to(eye, S.shape), jitter)


def mahalanobis(nu: jnp.ndarray, S: jnp.ndarray, jitter: float = 0.0) -> jnp.ndarray:
    """νᵀ S⁻¹ ν for ν (..., n), SPD S (..., n, n) -> (...,)."""
    x = spd_solve(S, nu, jitter)
    return jnp.sum(nu * x, axis=-1)


def gaussian_likelihood(nu: jnp.ndarray, S: jnp.ndarray) -> jnp.ndarray:
    """ψ = det(π S)^{-1/2} exp(-d_M/2).

    Matches the reference's likelihood (``correspondence_obj.cpp:80-97``)
    including its idiosyncratic normalization ``2 * M_PI_2 * S`` = π·S
    (M_PI_2 is π/2, so the constant is π rather than 2π).
    """
    chol = jnp.linalg.cholesky(symmetrize(S))
    d_m = mahalanobis(nu, S)
    n = S.shape[-1]
    # det(pi * S) = pi^n * det(S); det(S) = prod(diag(chol))^2
    log_det = n * jnp.log(jnp.pi) + 2.0 * jnp.sum(
        jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1
    )
    return jnp.exp(-0.5 * (d_m + log_det))


def quadratic_form(H: jnp.ndarray, Sigma: jnp.ndarray) -> jnp.ndarray:
    """H Σ Hᵀ over trailing dims; H (..., m, n), Σ (..., n, n) -> (..., m, m)."""
    return jnp.einsum("...ij,...jk,...lk->...il", H, Sigma, H)


def inv_det_small3(S: jnp.ndarray):
    """Closed-form (inverse, det) of batched 3×3 SPD matrices — one cofactor
    pass feeds both (the filters need S⁻¹ for the gain and det(S) for the
    association likelihood)."""
    a, b, c = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    d, e, f = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    g, h, i = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    Dc = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    Hc = -(a * f - c * d)
    I = a * e - b * d
    det = a * A + b * B + c * C
    inv = jnp.stack(
        [jnp.stack([A, Dc, G], -1), jnp.stack([B, E, Hc], -1),
         jnp.stack([C, F, I], -1)], -2,
    ) / det[..., None, None]
    return inv, det


def inv_small(S: jnp.ndarray) -> jnp.ndarray:
    """Closed-form inverse of batched 2×2 / 3×3 SPD matrices (..., n, n).

    Pure elementwise cofactor math instead of a factorization for the
    filter's innovation matrices.
    """
    n = S.shape[-1]
    if n == 2:
        a, b = S[..., 0, 0], S[..., 0, 1]
        c, d = S[..., 1, 0], S[..., 1, 1]
        det = a * d - b * c
        inv = jnp.stack(
            [jnp.stack([d, -b], -1), jnp.stack([-c, a], -1)], -2
        )
        return inv / det[..., None, None]
    if n == 3:
        a, b, c = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
        d, e, f = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
        g, h, i = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
        A = e * i - f * h
        B = -(d * i - f * g)
        C = d * h - e * g
        D = -(b * i - c * h)
        E = a * i - c * g
        F = -(a * h - b * g)
        G = b * f - c * e
        Hc = -(a * f - c * d)
        I = a * e - b * d
        det = a * A + b * B + c * C
        inv = jnp.stack(
            [jnp.stack([A, D, G], -1), jnp.stack([B, E, Hc], -1),
             jnp.stack([C, F, I], -1)], -2,
        )
        return inv / det[..., None, None]
    return spd_inverse(S)


def chi2_quantile(p: float, dof: int) -> float:
    """χ² quantile, computed host-side at trace time (reference uses
    boost::math::quantile, ``ekf_localization.cpp:126-128``)."""
    from scipy.stats import chi2

    return float(chi2.ppf(p, dof))

"""Chebyshev-filtered restarts (ChASE-style subspace acceleration).

At subspace collapse the reference simply keeps the first ``init_dim``
Ritz vectors (``src/davidson.f90:218``) — all information about the
unwanted part of the spectrum re-enters through subsequent corrections.
Chebyshev filtering (Saad; ChASE, arXiv:2205.02491) instead passes the
restart block through a degree-``d`` scaled Chebyshev polynomial of the
operator that is ~1 on the wanted (lowest) part of the spectrum and
exponentially small on the damping interval ``[a, b]`` covering the
unwanted part — each collapse then behaves like many power iterations
toward the wanted invariant subspace at the cost of ``d`` extra block
operator applications per collapse (collapses are 1-in-log iterations).

Shape: the filter is a three-term block recurrence of operator
applications — exactly the solver's hot op (SpMM on (n, init_dim)
blocks), jit-friendly (``fori_loop``, static degree), and sharding
transparent (the recurrence is elementwise in the sharded row dimension).

The damping interval's upper end ``b`` must bound the spectrum from
above; :func:`lanczos_upper_bound` estimates it once per solve with a
short Lanczos run (k steps => bound λ_max(T_k) + ||r_k||, the standard
safeguarded estimate ChASE uses).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def lanczos_upper_bound(apply_a, n: int, dtype, iters: int = 12,
                        seed: int = 7, safety: float = 1.05):
    """Upper bound of spec(A) from ``iters`` Lanczos steps.

    Returns ``λ_max(T_k) + ||r_k||`` (a true upper bound in exact
    arithmetic by the residual bound on Ritz values), scaled by a small
    ``safety`` factor against roundoff. One-time cost: ``iters`` single
    -vector operator applications.
    """
    dt = jnp.dtype(dtype)
    key = jax.random.PRNGKey(seed)
    v = jax.random.normal(key, (n,), dt)
    v = v / jnp.linalg.norm(v)

    def body(j, carry):
        v_prev, v, beta, alphas, betas = carry
        w = apply_a(v[:, None])[:, 0] - beta * v_prev
        alpha = jnp.dot(w, v)
        w = w - alpha * v
        # One full reorthogonalization step in spirit would need the
        # whole basis; for a BOUND the raw recurrence is sufficient (loss
        # of orthogonality only makes Ritz values repeat, not overshoot).
        beta_new = jnp.linalg.norm(w)
        v_new = jnp.where(beta_new > 0, w / jnp.where(beta_new > 0,
                                                      beta_new, 1.0), v)
        return (v, v_new, beta_new, alphas.at[j].set(alpha),
                betas.at[j].set(beta_new))

    alphas = jnp.zeros((iters,), dt)
    betas = jnp.zeros((iters,), dt)
    carry = (jnp.zeros_like(v), v, jnp.asarray(0.0, dt), alphas, betas)
    _, _, _, alphas, betas = jax.lax.fori_loop(0, iters, body, carry)
    T = (jnp.diag(alphas) + jnp.diag(betas[:-1], 1)
         + jnp.diag(betas[:-1], -1))
    theta = jnp.linalg.eigvalsh(T)[-1]
    return (theta + betas[-1]) * jnp.asarray(safety, dt)


def chebyshev_filter(apply_a, X, degree: int, a, b, lower_est):
    """Apply the scaled Chebyshev filter ``p(A) @ X`` damping ``[a, b]``.

    ``p`` is the degree-``degree`` Chebyshev polynomial of the first kind
    mapped so that ``[a, b]`` is the equi-oscillation interval; values
    below ``a`` (the wanted lowest eigenvalues) are amplified
    exponentially in the degree. Uses the σ-scaled recurrence (ChASE
    eq. 2.4-2.6 / Saad alg. 4.3) anchored at ``lower_est`` (an estimate
    of the smallest eigenvalue, e.g. the current lowest Ritz value) so
    intermediate blocks stay O(1) instead of overflowing.

    Args:
      apply_a: block operator application.
      X: (n, m) restart block (columns may include padded zeros — zero
        columns stay exactly zero through the linear recurrence).
      degree: polynomial degree (static; 0 or 1 returns X unchanged
        apart from the degree-1 shift — callers gate on degree >= 2).
      a: lower end of the damping interval (first UNWANTED Ritz value).
      b: upper end (upper bound of the spectrum).
      lower_est: wanted-end anchor for the σ scaling.
    """
    e = (b - a) / 2.0
    c = (b + a) / 2.0
    sigma1 = e / (c - lower_est)

    Y = (apply_a(X) - c * X) * (sigma1 / e)

    def body(_, carry):
        Xk, Yk, sigma = carry
        sigma_new = 1.0 / (2.0 / sigma1 - sigma)
        Yn = (apply_a(Yk) - c * Yk) * (2.0 * sigma_new / e) \
            - (sigma * sigma_new) * Xk
        return (Yk, Yn, sigma_new)

    # ``degree`` may be a traced int (auto-degree mode) — fori_loop
    # lowers to a while_loop with a dynamic trip count in that case.
    _, Y, _ = jax.lax.fori_loop(0, degree - 1, body, (X, Y, sigma1))
    return Y


def auto_degree(wanted_lo, a, b, dtype, target: float = 1e3,
                max_degree: int = 12):
    """Pick the filter degree from the spectral geometry of this restart.

    The scaled Chebyshev filter amplifies the wanted extreme relative to
    the damped interval by ~``cosh(d * acosh(t))`` with
    ``t = (c - λ_lo)/e`` (c, e = center/half-width of [a, b]); solving
    ``cosh(d * acosh(t)) >= target`` gives the smallest useful degree

        d = acosh(2 * target) / acosh(t)

    (the factor 2 absorbs cosh ≈ exp/2). Clamped to [2, max_degree]:
    well-separated problems (t >> 1) get a cheap low-degree filter,
    clustered ones (t → 1, acosh(t) → 0) hit the cap instead of burning
    unbounded operator applications per collapse. All inputs may be
    traced; the result is a traced int32 for the dynamic fori_loop.
    """
    dt = jnp.dtype(dtype)
    e = (b - a) / 2.0
    c = (b + a) / 2.0
    # Guard degenerate geometry (a ~ b or wanted inside the interval):
    # t <= 1 + tiny => acosh ~ 0 => capped degree.
    t = jnp.maximum((c - wanted_lo) / jnp.maximum(e, jnp.finfo(dt).tiny),
                    jnp.asarray(1.0, dt) + jnp.finfo(dt).eps)
    d = jnp.arccosh(jnp.asarray(2.0 * target, dt)) / jnp.arccosh(t)
    d = jnp.ceil(d).astype(jnp.int32)
    return jnp.clip(d, 2, max_degree)

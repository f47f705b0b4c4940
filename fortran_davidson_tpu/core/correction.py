"""Correction-vector schemes: DPR and GJD.

Mirrors the pluggable correction layer of the reference
(``src/davidson.f90:630-752``) with block-vectorized math:

- DPR (Diagonal-Preconditioned-Residue): one fused elementwise op over
  the whole residual block, ``corr[i, j] = r[i, j] / (lambda_j * B_ii -
  A_ii)`` (generalized; B_ii = 1 reproduces the standard form
  ``r / (lambda_j - A_ii)``, reference ``src/davidson.f90:688-696`` and
  ``:482-486``). Near-zero denominators are clamped instead of producing
  inf (see ``safe_denominator``).
- GJD (Generalized Jacobi-Davidson): solves, for every active Ritz pair,
  ``(I - x x^T)(A - lambda B)(I - x x^T) t = -r`` *matrix-free* with a
  column-batched MINRES — never materializing the n x n system the
  reference builds and DSYSV-factorizes per pair (``src/davidson.f90:
  719-732``). Note the reference deliberately uses ``I - x x^T`` with the
  raw Ritz column even in the generalized case (where ``x`` is
  B-orthonormal, not unit); we reproduce that operator exactly.

Unknown method strings raise at trace time (the reference silently returns
uninitialized memory, ``src/davidson.f90:653-669``).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from fortran_davidson_tpu.core.krylov import minres_block
from fortran_davidson_tpu.utils.dtypes import safe_denominator
from fortran_davidson_tpu.utils.errors import InvalidOptionsError

METHODS = ("DPR", "GJD", "OLSEN")


def validate_method(method: str) -> str:
    m = str(method).upper()
    if m not in METHODS:
        raise InvalidOptionsError(
            f"Unknown correction method {method!r}; available: {METHODS}")
    return m


def dpr_correction(R, lam, diag_a, diag_b, mask):
    """DPR correction for a block of residuals.

    Args:
      R: (n, m_max) residual block (inactive columns zero).
      lam: (m_max,) Ritz values (ascending; inactive entries ignored).
      diag_a: (n,) diagonal of A.
      diag_b: (n,) diagonal of B (ones for the standard problem).
      mask: (m_max,) active-column mask.
    """
    den = lam[None, :] * diag_b[:, None] - diag_a[:, None]
    den = safe_denominator(den)
    return (R / den) * mask[None, :]


def olsen_correction(R, lam, X, diag_a, diag_b, mask):
    """Olsen correction (Olsen, Jørgensen & Simons 1990).

    DPR's preconditioned residual ``K⁻¹r`` (K = diag(λB - A)) is NOT
    orthogonal to the Ritz vector: when the eigenvector is dominated by a
    coordinate whose diagonal sits at λ (exactly the diagonal-dominant
    regime), ``K⁻¹r`` collapses onto x and Davidson stagnates. Olsen's
    fix solves ``K t = -(r - μ x)`` with μ chosen so ``xᵀ t = 0``:

        t = K⁻¹ r - μ K⁻¹ x,   μ = (xᵀ K⁻¹ r) / (xᵀ K⁻¹ x)

    — one extra elementwise pass and two column dots over DPR. This is
    also the single-step form of the projected (Jacobi-Davidson)
    preconditioner: the same skew projection warm-starts the GJD inner
    solve (``gjd_preconditioner="olsen"``). The reference has only plain
    DPR (``src/davidson.f90:673-698``).
    """
    den = safe_denominator(lam[None, :] * diag_b[:, None] - diag_a[:, None])
    kinv_r = R / den
    kinv_x = X / den
    num = jnp.sum(X * kinv_r, axis=0)
    dnm = jnp.sum(X * kinv_x, axis=0)
    mu = jnp.where(jnp.abs(dnm) > 0, num / jnp.where(dnm != 0, dnm, 1.0),
                   0.0)
    return (kinv_r - kinv_x * mu[None, :]) * mask[None, :]


def _pseudo_projector(X):
    """Return T -> (I - x_j x_j^T) t_j applied column-wise as a block op."""
    def apply(T):
        return T - X * jnp.sum(X * T, axis=0, keepdims=True)
    return apply


def gjd_correction(apply_a: Callable, apply_b: Optional[Callable], lam, X, R,
                   mask, inner_iters: int, inner_tol: float,
                   diag_a=None, diag_b=None, olsen_start: bool = False,
                   scale: bool = True, return_inner_iters: bool = False,
                   warm_t=None):
    """GJD correction via batched matrix-free MINRES.

    When the operator diagonals are supplied, the per-pair correction
    equation is symmetrically scaled by the DPR diagonal,
    ``D_j = |lambda_j B_ii - A_ii|``: solve
    ``D^-1/2 P (A - lambda B) P D^-1/2 y = -D^-1/2 r`` and set
    ``t = D^-1/2 y``. The solution is identical in exact arithmetic, but
    MINRES converges on the scaled spectrum — for diagonal-dominant
    operators this collapses the inner iteration count the same way the
    DPR preconditioner powers the outer iteration. (The reference's GJD
    has no preconditioning at all: it factorizes the dense n x n system
    with DSYSV, ``src/davidson.f90:719-732``.)

    Args:
      apply_a / apply_b: block operator applications (apply_b None => B=I).
      lam: (m_max,) Ritz values.
      X: (n, m_max) Ritz vectors (inactive columns zero).
      R: (n, m_max) residuals (inactive columns zero).
      mask: (m_max,) active-column mask.
      inner_iters: static cap on MINRES iterations.
      inner_tol: relative residual tolerance of the inner solve — a
        scalar, or a per-column (m_max,) array (the loop's adaptive
        schedule passes outer-residual-linked tolerances).
      diag_a / diag_b: operator diagonals enabling the DPR scaling
        (``diag_b`` None means B = I for the scaling).
      warm_t: optional (n, m_max) previous-outer-iteration correction
        block recycled as the inner solve's initial guess
        (``DavidsonOptions.gjd_warm_start``). Projected ⊥ the current
        Ritz vectors, overshoot-guarded like the Olsen start, and —
        where a nonzero previous correction exists — preferred over it.

    The correction solve always runs under f32 matmul precision: a
    platform default that demotes f32 operands (TF32 on GPU tensor
    cores) corrupts the MINRES three-term
    recurrence (the inner Krylov is the most demotion-sensitive piece of
    the solver). NOTE this local pin is a guard for standalone use only —
    it is NOT sufficient for the full solve: the Gram/Ritz/residual
    matmuls in the outer loop are equally poisoned (measured: GJD+Olsen
    at 1M rows f32 diverges unless the WHOLE loop is pinned; see
    ``core.loop._precision_ctx`` / ``DavidsonOptions.matmul_precision``).
    f64 paths are unaffected (the context only governs f32 matmuls), so
    reference parity pins are untouched.
    """
    with jax.default_matmul_precision("float32"):
        return _gjd_correction_impl(
            apply_a, apply_b, lam, X, R, mask, inner_iters, inner_tol,
            diag_a, diag_b, olsen_start, scale, return_inner_iters, warm_t)


def _gjd_correction_impl(apply_a, apply_b, lam, X, R, mask, inner_iters,
                         inner_tol, diag_a, diag_b, olsen_start, scale,
                         return_inner_iters, warm_t=None):
    proj = _pseudo_projector(X)

    def shifted(T):
        AT = apply_a(T)
        BT = T if apply_b is None else apply_b(T)
        return AT - BT * lam[None, :]

    def op(T):
        return proj(shifted(proj(T)))

    rhs = -(R * mask[None, :])

    # Olsen warm start (projected preconditioner, single-step form): the
    # inner Krylov solve starts from the Olsen correction and only has to
    # resolve the remainder — solve op δ = rhs - op(t0), t = t0 + δ.
    # t0 is already ⊥ x (Olsen's defining property), so the projected
    # system's consistency is preserved. Measured: cuts inner MINRES
    # iterations at matched tolerance on diagonal-dominant operators.
    t0 = None
    rhs_orig = rhs
    if olsen_start and diag_a is not None:
        # (A - λB) t = -r with K = diag(λB - A):  t ≈ K⁻¹ r (DPR), made
        # ⊥ x the Olsen way. The inner solve then only resolves the
        # remainder, stopped at the ORIGINAL system's absolute target
        # (atol) — that is where the warm start turns into fewer
        # iterations.
        db0 = jnp.ones_like(diag_a) if diag_b is None else diag_b
        t0 = proj(olsen_correction(R, lam, X, diag_a, db0, mask))
    if warm_t is not None:
        # Cross-outer-iteration recycling: the previous raw correction,
        # re-projected ⊥ the CURRENT Ritz vectors (they rotated since).
        # Columns with no history (first iteration, or a pair whose
        # correction column was inactive) keep the Olsen start / cold
        # start; nonzero history wins — it solves the nearby previous
        # system exactly, which is a strictly better model of this one
        # than the diagonal surrogate.
        tw = proj(warm_t * mask[None, :])
        if t0 is None:
            t0 = tw
        else:
            has_w = jnp.linalg.norm(tw, axis=0) > 0
            t0 = jnp.where(has_w[None, :], tw, t0)
    if t0 is not None:
        # Overshoot guard: near a λ == diag collision the floored K makes
        # t0 huge (and a stale recycled correction can point anywhere),
        # and at working precision the remainder rhs - op(t0) then
        # carries catastrophic cancellation noise that the inner solve
        # faithfully turns into junk corrections (measured divergence at
        # 1M rows f32). Columns whose op(t0) dwarfs the rhs are scaled
        # back toward a cold start — graceful degradation.
        opt0 = op(t0)
        nr = jnp.linalg.norm(rhs, axis=0)
        no = jnp.linalg.norm(opt0, axis=0)
        s = jnp.where(no > 2.0 * nr,
                      2.0 * nr / jnp.where(no > 0, no, 1.0), 1.0)
        t0 = t0 * s[None, :]
        rhs = rhs - opt0 * s[None, :]

    def finish(t, iters):
        t = (t if t0 is None else t + t0) * mask[None, :]
        if return_inner_iters:
            return t, iters
        return t

    if diag_a is None or not scale:
        # Unscaled MINRES on the exact projected operator (reference
        # semantics). With a warm start, stop at the original system's
        # absolute target — the Olsen guess removes the diagonal-dominant
        # bulk of the solution, and the saved residual reduction converts
        # directly into saved iterations (the dpr-SCALED path gets no
        # such saving: its first scaled iteration already plays the role
        # of the diagonal solve).
        atol = (None if t0 is None
                else inner_tol * jnp.linalg.norm(rhs_orig, axis=0))
        t, iters = minres_block(op, rhs, maxiter=inner_iters,
                                rtol=inner_tol, col_active=mask,
                                return_iters=True, atol=atol)
        return finish(t, iters)

    # The DPR denominator vanishes near the Ritz coordinate (lambda ~
    # A_ii), where unbounded scaling would amplify the operator's
    # near-null direction and stall MINRES; the floor caps the scaling
    # condition number while still flattening the bulk diagonal spread.
    db = jnp.ones_like(diag_a) if diag_b is None else diag_b
    den = jnp.abs(lam[None, :] * db[:, None] - diag_a[:, None])
    floor = 1e-2 * jnp.mean(den, axis=0, keepdims=True)
    sc = jax.lax.rsqrt(jnp.maximum(den, jnp.maximum(floor, 1e-30)))

    def op_scaled(T):
        return sc * op(sc * T)

    atol = None
    if t0 is not None:
        # Absolute target in the SCALED residual norm of the original
        # system (what an unassisted solve would have stopped at).
        atol = inner_tol * jnp.linalg.norm(sc * rhs_orig, axis=0)
    y, iters = minres_block(op_scaled, sc * rhs, maxiter=inner_iters,
                            rtol=inner_tol, col_active=mask,
                            return_iters=True, atol=atol)
    return finish(sc * y, iters)

"""High-precision (refined) residuals and Rayleigh quotients in f32 storage.

The reference runs everything in real64
(``/root/reference/src/numeric_kinds.f90:10``) and checks absolute
residuals at 1e-8 (``src/davidson.f90:174``). With f32 storage a naive
f32 solve floors at ~sqrt(n)*eps ~ 1e-4..1e-3 residual at the 1M..10M-row
scale (round-1 measurement). This module restores f64-grade *measurement
and attainment* of small residuals using double-single arithmetic
(:mod:`fortran_davidson_tpu.utils.ds`) in exactly the places where f32
cancellation kills accuracy:

- the residual ``r = (A - λB)x``: for diagonal-dominant operators the
  cancellation lives in the diagonal term, so it is evaluated as
  ``A_off x - λ B_off x + ds((d_A - λ d_B) ∘ x)`` with the diagonal part
  in exact two_prod/two_sum arithmetic (``A_off = A.offdiag()``);
- the Rayleigh quotient ``λ = xᵀAx / xᵀBx``: compensated Dot2 column
  dots, refining the f32 projected-eigh Ritz values (whose error is
  ~eps*||H||) down to ~eps²;
- an optional post-solve *polish* of the k wanted eigenpairs with the
  eigenvectors held in double-single storage — pushing absolute
  residuals toward ~eps² * ||A||_local, below what any f32-stored vector
  can attain (storage rounding alone costs ~eps*λ).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from fortran_davidson_tpu.utils import ds as dsm
from fortran_davidson_tpu.utils.ds import DS


def pencil_shifted_diag_apply(diag_a, diag_b, lam_hi, lam_lo, X) -> DS:
    """``(diag_a - λ ∘ diag_b)[:, None] * X`` in double-single.

    ``diag_b=None`` means the standard problem (B = I). λ is a DS scalar
    per column: (k,) hi/lo. X: (n, k).
    """
    if diag_b is None:
        lam_prod_hi = jnp.broadcast_to(lam_hi[None, :],
                                       (diag_a.shape[0], lam_hi.shape[0]))
        lam_prod_lo = jnp.broadcast_to(lam_lo[None, :], lam_prod_hi.shape)
    else:
        # λ * d_B as a DS: exact product of the hi part + first-order lo.
        p, e = dsm.two_prod(lam_hi[None, :], diag_b[:, None])
        lam_prod_hi = p
        lam_prod_lo = e + lam_lo[None, :] * diag_b[:, None]
    # d_A - λ d_B in DS.
    s, e = dsm.two_sum(diag_a[:, None], -lam_prod_hi)
    shift_hi, shift_lo = dsm.fast_two_sum(s, e - lam_prod_lo)
    # (shift) * X in DS.
    p, e = dsm.two_prod(shift_hi, X)
    return DS(*dsm.fast_two_sum(p, e + shift_lo * X))


def _diag_quad_form(d, X, Y=None, extra_lo=None) -> DS:
    """Fully compensated Σ_i d_i X_i Y_i per column (Y defaults to X).

    Delegates to :func:`~fortran_davidson_tpu.utils.ds.weighted_dot_cols_ds`
    (two_prod on BOTH multiplications — a plain f32 product of the
    near-unit terms (d x)·x would round at eps*|d x²| per element, and
    since the diagonal dominates the Rayleigh quotient that single
    rounding becomes an eps-relative error on λ; measured: exactly the
    6e-8 floor this replaced). ``extra_lo`` adds a per-element
    first-order term (e.g. the x_lo channel cross terms of a DS iterate).
    """
    return dsm.weighted_dot_cols_ds(d, X, Y, extra_lo=extra_lo)


def _assemble_residual(AoffX, shift: DS, lam: DS, BoffX=None) -> DS:
    """R = A_off x + (d_A - λ d_B)∘x [- λ B_off x] with EXACT adds.

    The two large terms cancel to ~the true residual near convergence; a
    plain f32 add would floor the measurement at eps*|A_off x| per
    element (and any iteration driven by it would converge UP to that
    noise). two_sum keeps the cancellation exact; only the operands' own
    elementwise rounding (~eps * per-element magnitudes) remains.
    """
    s, e = dsm.two_sum(AoffX, shift.hi)
    lo = e + shift.lo
    if BoffX is not None:
        p, ep = dsm.two_prod(lam.hi, BoffX)
        s2, e2 = dsm.two_sum(s, -p)
        s, lo = s2, lo + e2 - ep - lam.lo * BoffX
    return DS(*dsm.fast_two_sum(s, lo))


def _ds_col_norms(R: DS):
    """Column norms of a DS residual: ||hi||² + 2<hi, lo> compensated."""
    sq = dsm.col_sumsq_pair_ds(R.hi, R.lo)
    # Guard tiny negative roundoff before the sqrt.
    return dsm.ds_sqrt(DS(jnp.maximum(sq.hi, 0.0),
                          jnp.where(sq.hi > 0, sq.lo, 0.0))).to_float()


def _ds_matmul_cols(M_ds: DS, Wk) -> DS:
    """``M @ Wk`` with M an (m, m) DS matrix, exact to ~eps² (m is the
    small projected dimension — O(m²k) elementwise work)."""
    p, e = dsm.two_prod(M_ds.hi[:, :, None], Wk[None, :, :])  # (m, m, k)
    my = dsm.ds_sum_tree(p.transpose(1, 0, 2), axis=0,
                         lo=e.transpose(1, 0, 2))
    return dsm.ds_add(my, dsm.ds(jnp.einsum(
        "ij,jk->ik", M_ds.lo, Wk, preferred_element_type=M_ds.lo.dtype)))


def _first_order_update(W, w, r_f, k: int):
    """Eigenbasis perturbation ``y_j ← y_j + Σ_{i≠j} cᵢⱼ/(θ_j−θ_i) yᵢ``
    from the projected residual coefficients ``c = Wᵀ r`` — shared by the
    standard and pencil refinements (for the pencil, Wᵀ r is the correct
    projection because W is S-orthonormal). Padded-block eigenpairs
    participate harmlessly (huge |θ_j − θ_i| denominators)."""
    m = W.shape[0]
    c = jnp.dot(W.T, r_f, preferred_element_type=r_f.dtype)  # (m, k)
    denom = w[:k][None, :] - w[:, None]  # (m, k): θ_j - θ_i
    gap_floor = 16.0 * jnp.finfo(r_f.dtype).eps * (
        jnp.abs(w[:k])[None, :] + 1.0)
    safe = jnp.where(jnp.abs(denom) < gap_floor, jnp.inf, denom)
    coef = c / safe
    # Zero the self-term (and exact-degenerate partners via the floor).
    eye_k = (jnp.arange(m)[:, None] == jnp.arange(k)[None, :])
    coef = jnp.where(eye_k, 0.0, coef)
    return W[:, :k] + jnp.dot(W, coef, preferred_element_type=W.dtype)


def refine_ritz(H_ds: DS, w, W, k: int):
    """First-order refinement of the k wanted eigenvectors of the
    projected matrix, beyond f32-eigh accuracy.

    The f32 ``eigh`` of H delivers eigenvectors with ~eps*||H||/gap
    error; rotated into the big space that floors the attainable
    residual at ~eps*||H|| (measured: ~4e-6 at ||H||~60 — above 1e-6
    tolerances). With H held as a DS pair, the small residual
    ``r_j = H y_j - θ_j y_j`` is computable to ~eps² (the cancellation
    is exact), and standard first-order perturbation in the eigenbasis,

        y_j ← y_j + Σ_{i≠j} (u_iᵀ r_j)/(θ_j - θ_i) u_i,

    recovers the square of the accuracy at O(m²k) cost.
    """
    Wk = W[:, :k]
    # DS evaluation of H @ Wk - Wk * θ (m x k, all small).
    hy = _ds_matmul_cols(H_ds, Wk)
    tp, te = dsm.two_prod(Wk, w[None, :k])
    r = dsm.ds_sub(hy, DS(tp, te))
    r_f = r.hi + r.lo  # (m, k) — true residual magnitudes, well above eps²
    return _first_order_update(W, w, r_f, k)


def refine_ritz_pencil(H_ds: DS, S_ds: DS, w, W, k: int):
    """First-order refinement of the k wanted eigenvectors of the
    projected PENCIL ``H y = θ S y``, beyond f32 accuracy.

    W is S-orthonormal (``WᵀSW = I`` — DSYGV semantics, matching the
    reference's always-generalized free engine,
    ``/root/reference/src/davidson.f90:277-279``). With H and S both
    held as DS pairs the small pencil residual ``r_j = H y_j − θ_j S y_j``
    is computable to ~eps²; expanding ``δy_j = Σ cᵢ yᵢ`` and projecting
    with ``yᵢᵀ`` (using ``yᵢᵀ H y_l = θ_i δᵢl`` and ``yᵢᵀ S y_l = δᵢl``
    from S-orthonormality) gives the same update as the standard case,

        y_j ← y_j + Σ_{i≠j} (yᵢᵀ r_j)/(θ_j − θ_i) yᵢ.
    """
    Wk = W[:, :k]
    hy = _ds_matmul_cols(H_ds, Wk)
    sy = _ds_matmul_cols(S_ds, Wk)
    # θ_j * (S y)_j in DS.
    tp, te = dsm.two_prod(sy.hi, w[None, :k])
    tsy = DS(tp, te + sy.lo * w[None, :k])
    r = dsm.ds_sub(hy, tsy)
    r_f = r.hi + r.lo
    return _first_order_update(W, w, r_f, k)


class RefinedPairs(NamedTuple):
    evals: jnp.ndarray       # (k,) refined Rayleigh quotients (f32)
    errors: jnp.ndarray      # (k,) true residual 2-norms
    residual: jnp.ndarray    # (n, k) high-precision residual block (f32)


def refined_pairs(A_off, diag_a, X, B_off=None, diag_b=None) -> RefinedPairs:
    """Refined eigenvalues + true residuals for the column block ``X``.

    One off-diagonal operator application per operator (the only O(nnz)
    work); everything else is compensated elementwise/reduction math.
    ``X`` need not be perfectly normalized — the Rayleigh quotient divides
    by the compensated ``xᵀBx``.
    """
    gen = diag_b is not None
    AoffX = A_off.matmat(X)
    BoffX = B_off.matmat(X) if (gen and B_off is not None) else None

    # Compensated Rayleigh numerator xᵀ A x = xᵀ(A_off x) + Σ d_A x².
    num = dsm.ds_add(dsm.dot_cols_ds(X, AoffX),
                     _diag_quad_form(diag_a, X))
    # Denominator xᵀ B x (compensated); standard problem: xᵀx (Dot2 —
    # the squared products must be exact too, or den carries eps*den).
    if gen:
        den = dsm.dot_cols_ds(X, BoffX) if BoffX is not None else dsm.ds(
            jnp.zeros(X.shape[1], X.dtype))
        den = dsm.ds_add(den, _diag_quad_form(diag_b, X))
    else:
        den = dsm.dot_cols_ds(X, X)
    # A nonexistent pair (identically-zero column — e.g. a rank-deficient
    # warm start before the basis fills out) has xᵀBx == 0 exactly;
    # dividing would mint a NaN that survives every downstream
    # mask-*multiply* (NaN*0 = NaN) and poisons the basis via the expand
    # write. Floor the denominator to 1 for exactly-zero columns: the
    # numerator is exactly zero there too, so λ, the residual, and the
    # error all come out 0 and the loop's pair-existence guard decides.
    dead = den.hi == 0
    den = DS(jnp.where(dead, jnp.ones_like(den.hi), den.hi),
             jnp.where(dead, jnp.zeros_like(den.lo), den.lo))
    lam = dsm.ds_div(num, den)

    # True residual with the diagonal cancellation in DS and the final
    # (canceling) adds exact.
    shift = pencil_shifted_diag_apply(diag_a, diag_b, lam.hi, lam.lo, X)
    lam_b = DS(jnp.broadcast_to(lam.hi[None, :], X.shape),
               jnp.broadcast_to(lam.lo[None, :], X.shape))
    R = _assemble_residual(AoffX, shift, lam_b, BoffX)
    errors = _ds_col_norms(R)
    return RefinedPairs(evals=lam.to_float(), errors=errors,
                        residual=R.hi + R.lo)


class PolishResult(NamedTuple):
    evals: jnp.ndarray        # (k,) hi words of the refined eigenvalues
    evecs_hi: jnp.ndarray     # (n, k)
    evecs_lo: jnp.ndarray     # (n, k) double-single low words
    errors: jnp.ndarray       # (k,) final true residual norms
    # Low words of the eigenvalues: ``evals`` alone carries the f32
    # representation rounding (~eps/2·|λ|, i.e. 6e-8·λ — ABOVE a 1e-8
    # tolerance), so residual-grade consumers must use
    # ``float64(evals) + float64(evals_lo)`` on the host.
    evals_lo: jnp.ndarray = None  # (k,)


def polish(A_off, diag_a, evals, evecs, iterations: int = 3,
           B_off=None, diag_b=None, update: str = "dpr") -> PolishResult:
    """Jacobi (DPR-style) eigenpair refinement with double-single vectors.

    ``update="olsen"`` replaces the floored DPR step with the
    Olsen-projected update ``δ = M⁻¹r − μ M⁻¹x`` (μ chosen so the
    explosion along ``M⁻¹x`` cancels), using near-exact denominators.
    This is the classical cure for the DPR breakdown when λ falls
    within the denominator floor of a diagonal entry (λ ≈ d_i): the
    floored DPR update FREEZES that coordinate at its incoming value,
    fixed-pointing the polish at the incoming error (observed at the
    10M-row lowest-20 north star: pair 1 with λ₁ = 1 − 1.6e-7 against
    d₁ = 1 stuck at 2.5e-8; Olsen reaches the true floor).

    f32 *storage* of an eigenvector already floors the residual at
    ~eps*λ (rounding x elementwise perturbs Ax by ~eps*d∘x). Holding the
    iterate as a DS pair removes that floor; combined with the refined
    residual this converges absolute residuals toward the reference's
    1e-8 regime for diagonal-dominant operators (the same regime where
    Jacobi iteration itself converges). Cost per iteration: one
    off-diagonal operator application on (n, 2k) columns (hi and lo
    passed through A_off separately — exact to first order).
    """
    if update not in ("dpr", "olsen"):
        raise ValueError(
            f"polish update must be 'dpr' or 'olsen', got {update!r}")
    gen = diag_b is not None
    x_hi = evecs
    x_lo = jnp.zeros_like(evecs)
    lam = evals
    lam_ds = dsm.ds(evals)  # iterations=0: reported values pass through
    errors = None

    for _ in range(iterations):
        # A_off @ x in DS. Preferred: the operator's own matmat_ds
        # (compensated structural apply — the f32 apply's OUTPUT rounding
        # alone floors the measurable residual at ~eps/2·‖A_off x‖,
        # which at 10M-row scale sits right at the 1e-8 contract).
        # Fallback: one f32 apply per channel — exact to ~eps² in the
        # cancellation but carrying the apply's own output rounding.
        Yds = A_off.matmat_ds(x_hi, x_lo)
        if Yds is not None:
            AoffX, Aoff_lo = Yds
        else:
            AoffX = A_off.matmat(x_hi) + A_off.matmat(x_lo)
            Aoff_lo = None
        BoffX = (B_off.matmat(x_hi) + B_off.matmat(x_lo)) if (
            gen and B_off is not None) else None

        # Refined Rayleigh quotient at the DS iterate (x_lo cross terms
        # are first-order small — f32 in the lo channels suffices).
        num = dsm.ds_add(
            dsm.dot_cols_ds(x_hi, AoffX),
            _diag_quad_form(diag_a, x_hi,
                            extra_lo=2.0 * (diag_a[:, None] * x_lo) * x_hi))
        if Aoff_lo is not None:
            num = dsm.ds_add(num, dsm.ds(jnp.sum(x_hi * Aoff_lo, axis=0)))
        if gen:
            den = dsm.ds_add(
                dsm.dot_cols_ds(x_hi, BoffX) if BoffX is not None
                else dsm.ds(jnp.zeros_like(lam)),
                _diag_quad_form(diag_b, x_hi,
                                extra_lo=2.0 * (diag_b[:, None] * x_lo)
                                * x_hi))
        else:
            den = dsm.col_sumsq_pair_ds(x_hi, x_lo)
        lam_ds = dsm.ds_div(num, den)
        lam = lam_ds.to_float()

        # True residual at the DS iterate: exact two_sum assembly (a
        # plain f32 add of the canceling terms would inject ~eps*|A_off x|
        # noise every iteration, and the Jacobi update would converge UP
        # to that noise instead of down to the true floor). The x_lo
        # channel's diagonal term is first-order small — f32 suffices
        # for it, folded into the lo channel.
        shift = pencil_shifted_diag_apply(diag_a, diag_b, lam_ds.hi,
                                          lam_ds.lo, x_hi)
        dB = diag_b[:, None] if gen else 1.0
        shift_lo_term = (diag_a[:, None] - lam_ds.hi[None, :] * dB) * x_lo
        if Aoff_lo is not None:
            shift_lo_term = shift_lo_term + Aoff_lo
        lam_b = DS(jnp.broadcast_to(lam_ds.hi[None, :], x_hi.shape),
                   jnp.broadcast_to(lam_ds.lo[None, :], x_hi.shape))
        R_ds = _assemble_residual(
            AoffX, DS(shift.hi, shift.lo + shift_lo_term), lam_b, BoffX)
        errors = _ds_col_norms(R_ds)
        # The update divides elementwise — relative eps of each TRUE
        # residual element is harmless (the amplification near d ≈ λ
        # cancels against the (d - λ) factor in the residual it causes).
        R = R_ds.hi + R_ds.lo

        # DPR update in DS: δ = r / (λ - d_A) (safe-floored), x ← x - δ...
        # sign convention: Davidson DPR is δ = r / (λ B_d - d_A); adding δ.
        denom = lam[None, :] * (diag_b[:, None] if gen else 1.0) \
            - diag_a[:, None]
        floor = 1e-3 * jnp.maximum(jnp.abs(lam)[None, :], 1.0)
        den_fl = jnp.where(jnp.abs(denom) < floor,
                           jnp.sign(denom) * floor
                           + (denom == 0) * floor,
                           denom)
        delta = R / den_fl
        if update == "olsen":
            # Near-exact denominators (floor only against literal /0 at
            # machine scale) + the Olsen projection. The raw M⁻¹r blows
            # up along coordinates with λ ≈ d, but μ M⁻¹x blows up
            # identically — the difference is finite and points at the
            # eigenvector, so those coordinates keep updating instead of
            # freezing under a conservative floor.
            tiny = 1e-30 + 1e-12 * jnp.maximum(jnp.abs(lam)[None, :], 1.0)
            sgn = jnp.where(denom < 0, -1.0, 1.0)
            den_raw = jnp.where(jnp.abs(denom) < tiny, sgn * tiny, denom)
            Mr = R / den_raw
            Mx = x_hi / den_raw
            mu_den = jnp.sum(x_hi * Mx, axis=0)
            # μ's denominator Σ xᵢ²/denᵢ can cancel toward zero when den
            # changes sign across coordinates (λ inside the diagonal's
            # range — the very regime Olsen targets). Once |mu_den| sinks
            # to the summation's own noise (~eps·Σ|terms|), μ is garbage
            # and the projected step could regress BELOW the DPR result;
            # those columns take the floored-DPR delta instead.
            mag = jnp.sum(jnp.abs(x_hi * Mx), axis=0)
            noise = 16.0 * jnp.finfo(R.dtype).eps * mag + 1e-30
            ill = jnp.abs(mu_den) < noise
            mu_den = jnp.where(ill, jnp.where(mu_den < 0, -noise, noise),
                               mu_den)
            mu = jnp.sum(x_hi * Mr, axis=0) / mu_den
            delta = jnp.where(ill[None, :], delta,
                              Mr - mu[None, :] * Mx)
        s, e2 = dsm.two_sum(x_hi, delta)
        x_hi, x_lo = dsm.fast_two_sum(s, e2 + x_lo)

        # Renormalize in DS (keeps the Rayleigh quotient well-scaled).
        nrm = dsm.ds_sqrt(dsm.col_sumsq_pair_ds(x_hi, x_lo))
        inv = dsm.ds_div(dsm.ds(jnp.ones_like(lam)), nrm)
        p2, e3 = dsm.two_prod(x_hi, inv.hi[None, :])
        x_hi, x_lo = dsm.fast_two_sum(
            p2, e3 + x_hi * inv.lo[None, :] + x_lo * inv.hi[None, :])

    ehi, elo = dsm.fast_two_sum(lam_ds.hi, lam_ds.lo)
    return PolishResult(evals=ehi, evecs_hi=x_hi, evecs_lo=x_lo,
                        errors=errors, evals_lo=elo)

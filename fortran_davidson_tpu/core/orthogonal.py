"""Masked block orthonormalization (replacement for DGEQRF/DORGQR).

The reference re-orthonormalizes the *entire* grown basis with a full
Householder QR every expansion (``src/davidson.f90:213`` ->
``src/lapack_wrapper.f90:176-236``), which costs O(n m^2) and — crucially
for us — rewrites every column, invalidating any cached A@V.

This framework instead keeps the existing basis columns untouched and
orthonormalizes only the *new* block against them with CGS2 (classical
Gram-Schmidt applied twice — "twice is enough", Giraud et al.), followed by
an intra-block thin QR. In exact arithmetic the resulting span equals the
reference's QR span, so Ritz values and therefore iteration counts are
preserved, while A/B need only be applied to the new columns.

All routines operate on *padded* bases: ``V`` has static shape
``(n, m_max)`` whose active columns are exactly the nonzero ones (padded
columns are identically zero), so no explicit mask arguments are needed for
the Gram products — zero columns contribute zero.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def col_mask(m, m_max: int, dtype):
    """(m_max,) float mask: 1.0 for columns < m (m may be traced)."""
    return (jnp.arange(m_max) < m).astype(dtype)


def project_out(V, block, precise: bool = False):
    """Remove the component of ``block`` lying in span(V's nonzero columns).

    ``precise``: compensated coefficients (V^T block) — the naive f32 dot
    carries ~sqrt(n)*eps relative noise, which caps how small a genuine
    new direction the projection can leave standing (the refined path's
    corrections live exactly in that regime).

    ``V`` may arrive PRE-CHUNKED as ``(n/c, c, m)`` (the chunked-carry
    engine, ``carry_layout="chunked"``); ``block`` is always flat
    ``(n, b)``. The chunked form contracts with the same per-element
    order, so results are bit-identical — but the Gram needs no
    relayout of V.
    """
    if V.ndim == 3:
        if not precise:
            # Chunked carries only exist on the refined path (config
            # validation enforces refined=True and cholqr2); a plain
            # non-compensated Gram has no bit-identical chunked form.
            raise ValueError(
                "project_out: chunked (3-D) V requires precise=True")
        from fortran_davidson_tpu.utils.ds import gram_ds_pre
        r, c, m = V.shape
        bc = block.reshape(r, c, block.shape[1])
        g = gram_ds_pre(V, bc)
        coeffs = g.hi + g.lo
        proj = jnp.einsum("rcm,mp->rcp", V, coeffs,
                          preferred_element_type=block.dtype)
        return block - proj.reshape(block.shape)
    if precise:
        from fortran_davidson_tpu.utils.ds import gram_ds
        g = gram_ds(V, block)
        coeffs = g.hi + g.lo
    else:
        coeffs = jnp.dot(V.T, block, preferred_element_type=block.dtype)
    return block - jnp.dot(V, coeffs, preferred_element_type=block.dtype)


# NOTE on vanished correction columns: the reference's full Householder QR
# silently completes them with arbitrary orthonormal directions
# (``src/lapack_wrapper.f90:214-231`` never fails). We deliberately do NOT
# reproduce that: an arbitrary (random) direction has a Rayleigh quotient
# of order mean(diag A), and on wide-spectrum problems (diag up to ~n) it
# inflates ||H|| until the working-precision eigh can no longer resolve
# the *small* Ritz values — at float32 this destroys convergence outright
# (residuals jump from 1e-4 back to 1e-1). A column whose post-projection
# norm collapses relative to its pre-projection norm is cancellation
# noise, not information: it is DROPPED (zeroed), shrinking the effective
# expansion — the numerically meaningful part of the reference schedule.


def orthonormalize_block(V, block, mask, n_reorth: int = 2,
                         method: str = "cholqr2", precise: bool = False):
    """Orthonormalize ``block`` against the padded basis ``V`` and itself.

    Args:
      V: (n, m_max) padded orthonormal basis (padded columns exactly zero).
      block: (n, b_max) candidate new directions; only columns where
        ``mask`` is 1 are meaningful and they must form a *prefix*.
      mask: (b_max,) float prefix mask of active block columns.
      n_reorth: number of CGS passes against V (2 = CGS2).

    Returns:
      ``(q, alive)``: (n, b_max) block with orthonormal active columns,
      orthogonal to the active columns of V (masked/dropped columns are
      exactly zero), and the (b_max,) float mask of surviving columns —
      computed here for free so the solver loop never has to re-derive
      column activity with a full pass over the basis.
    """
    dt = block.dtype
    block = block * mask[None, :]
    norms_before = jnp.linalg.norm(block, axis=0)
    for _ in range(n_reorth):
        block = project_out(V, block, precise=precise)
    # Drop columns that lost (nearly) all their mass to the projection —
    # whatever survives is dominated by roundoff of the subtraction, not
    # by a new search direction (see module note above). sqrt(eps) is the
    # classic selective-reorthogonalization threshold; with compensated
    # projection coefficients (precise) the survivor floor set by the
    # remaining f32 V@coeffs matmul is ~sqrt(m)*eps, so genuinely small
    # new directions down to ~256*eps are signal, not noise.
    norms_after = jnp.linalg.norm(block, axis=0)
    eps = jnp.finfo(dt).eps
    drop_tol = 256.0 * eps if precise else jnp.sqrt(eps)
    alive = (norms_after > drop_tol * jnp.maximum(
        norms_before, jnp.finfo(dt).tiny)) & mask.astype(bool)
    block = block * alive[None, :].astype(dt)
    mask = mask * alive.astype(dt)
    # Noise floor for SVQB's whitening (precise path): each surviving
    # column carries broadband rounding noise at ~eps*sqrt(n) RELATIVE
    # amplitude (accumulated elementwise rounding of the residual /
    # correction pipeline). When correction columns are strongly
    # correlated (structurally common on separable/clustered operators),
    # their Gram's small eigenvalues are the DIFFERENCE directions; any
    # difference below the noise floor is junk, and rsqrt-whitening would
    # install it as a unit basis vector with a mean-diagonal-scale
    # Rayleigh quotient — inflating ||H|| until the working-precision
    # eigh destroys the wanted pairs (measured at 1M rows f32: residuals
    # 5e-6 -> 5e-3 and a frozen basis). Junk amplitude a maps to a Gram
    # eigenvalue a^2, hence the squared threshold.
    rank_rtol = None
    if precise:
        n = block.shape[0]
        rank_rtol = max(block.shape[1] * float(eps),
                        float((10.0 * eps) ** 2 * n))
    # Intra-block orthonormalization. Active columns form a prefix, so the
    # leading columns of Q from a thin QR span them; trailing Q columns are
    # arbitrary orthonormal directions and get masked back to zero.
    if method == "qr":
        # Compact survivors to a prefix first: with an interior zero
        # column, Householder QR routes components of LATER columns onto
        # the arbitrary completion column at the hole, and masking then
        # discards them — the masked Q would no longer span the surviving
        # directions. Trailing zero columns are harmless.
        order = jnp.argsort(jnp.logical_not(alive), stable=True)
        block = block[:, order]
        mask = mask[order]
        q, _ = jnp.linalg.qr(block)
        q = q * mask[None, :]
        # One more sweep against V: Householder QR completes zero/near-zero
        # columns with arbitrary directions that may have components in
        # span(V); renormalize afterwards (safe for exactly-zero columns).
        q = project_out(V, q)
        norms = jnp.linalg.norm(q, axis=0)
        inv = jnp.where(norms > 0, 1.0 / jnp.where(norms > 0, norms, 1.0),
                        0.0)
        return q * inv[None, :], (norms > 0.5).astype(dt)
    # Rank-revealing SVQB: rank-deficient correction blocks shed their
    # null directions, and the kept basis is compacted into a column
    # prefix. SVQB only combines the CGS2-projected columns (it never
    # invents directions), so the combinations stay orthogonal to V and
    # no extra cleanup sweep is needed — saving four streaming passes
    # over the (n, m_max) arrays per iteration.
    return svqb(block, mask, rank_rtol=rank_rtol, return_alive=True,
                precise=precise)


def _gram(X, precise: bool):
    """Gram X^T X — compensated when ``precise`` (see subspace.project)."""
    if precise:
        from fortran_davidson_tpu.utils.ds import gram_ds
        g = gram_ds(X)
        return g.hi + g.lo
    return jnp.dot(X.T, X, preferred_element_type=X.dtype)


def cholqr_once(X, unit_diag=None, jitter: float = 0.0,
                precise: bool = False):
    """One CholeskyQR pass: X = Q R via R = chol(X^T X)^T, Q = X R^{-1}.

    All heavy work is one Gram matmul (a psum under row sharding)
    plus an m x m Cholesky/triangular solve — the accelerator shape of
    tall-skinny QR, replacing the Householder DGEQRF/DORGQR of the
    reference (``src/lapack_wrapper.f90:176-236``) which XLA lowers to a
    slow sequential loop.

    ``unit_diag``: optional (m,) 0/1 mask; positions with 0 get a unit
    Gram diagonal so exactly-zero (padded) columns pass through as zero
    columns instead of breaking the factorization.

    ``precise``: compensated Gram — the orthogonality of the basis is
    bounded by how accurately the Gram can be MEASURED; a naive f32 Gram
    at n=10M mismeasures by ~sqrt(n)*eps ~ 2e-4 and no number of
    CholeskyQR passes can correct below that.
    """
    G = _gram(X, precise)
    if unit_diag is not None:
        G = G + jnp.diag(1.0 - unit_diag)
    if jitter:
        # Relative diagonal regularization: keeps the factorization finite
        # for (near-)parallel columns, where Householder QR would invent an
        # arbitrary completion direction anyway. Spans are unaffected.
        G = G + jitter * jnp.mean(jnp.diagonal(G)) * jnp.eye(
            G.shape[0], dtype=G.dtype)
    L = jnp.linalg.cholesky(G)
    # Q = X L^{-T} via an explicit m x m triangular inverse + GEMM (the
    # standard GPU CholQR formulation) — solving against ``X.T``
    # would transpose the whole tall block (full-array relayout, see
    # ``_tall_gram_dot``). The inverse's extra rounding is second-order
    # and the CholQR2 second pass cleans it up.
    Linv = jax.scipy.linalg.solve_triangular(
        L, jnp.eye(L.shape[0], dtype=L.dtype), lower=True)
    Q = jnp.dot(X, Linv.T, preferred_element_type=X.dtype)
    return Q, L.T


def cholqr2(X, unit_diag=None, jitter: float = 0.0, precise: bool = False):
    """CholeskyQR2 (Yamamoto et al.): two passes give orthogonality at
    working precision for cond(X) up to ~1/sqrt(eps)."""
    Q1, R1 = cholqr_once(X, unit_diag, jitter, precise)
    Q2, R2 = cholqr_once(Q1, unit_diag, jitter, precise)
    return Q2, jnp.dot(R2, R1, preferred_element_type=X.dtype)


def svqb(block, mask, rank_rtol=None, return_alive: bool = False,
         precise: bool = False):
    """SVQB (Stathopoulos & Wu 2002): rank-revealing block
    orthonormalization via the eigendecomposition of the Gram matrix.

    Returns a block whose columns are an orthonormal basis of the
    *numerical* column space — directions whose Gram eigenvalue falls
    below ``rank_rtol * s_max`` are dropped (zero columns), instead of
    being completed with arbitrary vectors the way Householder QR (and
    the reference's DGEQRF) would. On wide-spectrum problems arbitrary
    completions carry O(mean diag) Rayleigh quotients and wreck the
    projected eigenproblem at working precision; dropping is the
    numerically meaningful behavior. Correction blocks are routinely
    rank-deficient (near-converged pairs, separable operators), so this
    is the solver's default intra-block orthonormalization.

    ``mask``: active-column mask (inactive columns must be zero and stay
    zero). Column order is not preserved (it is a basis, not a pivoted
    factorization).
    """
    dt = block.dtype
    m_max = block.shape[1]
    norms = jnp.linalg.norm(block, axis=0)
    inv = jnp.where(norms > 0, 1.0 / jnp.where(norms > 0, norms, 1.0), 0.0)
    Bh = block * inv[None, :]
    active = (norms > 0).astype(dt) * mask
    G = _gram(Bh, precise)
    G = G + jnp.diag(1.0 - active)  # unit rows for inactive/zero columns
    s, U = jnp.linalg.eigh(G)
    if rank_rtol is None:
        rank_rtol = m_max * float(jnp.finfo(dt).eps)
    keep = s > rank_rtol * s[-1]
    factor = jnp.where(keep, jax.lax.rsqrt(jnp.maximum(s, jnp.finfo(dt).tiny)),
                       0.0).astype(dt)
    Q = jnp.dot(Bh, U * factor[None, :], preferred_element_type=dt)
    # Refinement pass (the CholQR2 second sweep) on the surviving columns.
    alive = (jnp.sum(Q * Q, axis=0) > 0.5).astype(dt)
    Q, _ = cholqr_once(Q * alive[None, :], unit_diag=alive, precise=precise)
    Q = Q * alive[None, :]
    # Kept directions come out in eigh order, interleaved with zero
    # columns (dropped noise sorts first, the padded unit block wherever
    # its eigenvalue lands). Compact them into a prefix so the caller can
    # place the block by column count alone.
    order = jnp.argsort(jnp.logical_not(alive.astype(bool)), stable=True)
    if return_alive:
        return Q[:, order], alive[order]
    return Q[:, order]


def thin_qr_collapse(X, method: str = "cholqr2", precise: bool = False):
    """Thin QR used at subspace collapse.

    At collapse the reference sets ``V <- V @ W[:, :init_dim]``
    (``src/davidson.f90:218``) *without* re-orthonormalizing — in the
    generalized problem W is only B-orthogonal, so the collapsed basis is
    not orthonormal and the reference relies on the next DSYGV to cope.
    We keep the invariant "V orthonormal" instead: QR the collapsed block
    and return (Q, R) so cached A@V / B@V can be updated by a triangular
    solve (A@Q = (A@X) R^{-1}) with *no* extra operator applications.
    Identical span => identical Ritz values => iteration-count parity.

    The collapsed block is Ritz vectors (orthonormal, or B-orthonormal
    with a well-conditioned B, in exact arithmetic), so CholeskyQR2 is
    unconditionally stable here; ``method="qr"`` falls back to Householder.
    """
    if method == "qr":
        return jnp.linalg.qr(X)
    return cholqr2(X, precise=precise)


def right_tri_solve(Y, R):
    """Compute Y @ R^{-1} for upper-triangular R (used to update caches).

    Uses an explicit m x m triangular inverse + GEMM instead of solving
    against ``Y.T`` — transposing the tall block would relayout the
    whole array (see ``_tall_gram_dot``).
    """
    Rinv = jax.scipy.linalg.solve_triangular(
        R, jnp.eye(R.shape[0], dtype=R.dtype), lower=False)
    return jnp.dot(Y, Rinv, preferred_element_type=Y.dtype)

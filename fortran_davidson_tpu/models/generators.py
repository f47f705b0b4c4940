"""Problem generators (test fixtures and benchmark workloads).

Counterparts of the reference's fixtures:

- :func:`generate_diagonal_dominant` mirrors
  ``src/array_utils.f90:86-113``: random symmetric off-diagonal entries of
  magnitude ``sparsity``, diagonal ``1..n`` (or a constant ``diag_val``).
- :func:`surrogate_hamiltonian` / :func:`surrogate_overlap` replace the
  reference's "expensive on-the-fly" analytic operators
  (``src/tests/test_utils.f90:37-116``, ``src/benchmark_free.f90:38-76``)
  with *separable* low-rank-plus-diagonal operators: trig off-diagonals
  like ``cos(theta_i + theta_j)`` expand as rank-2 outer products, so the
  matrix-free apply is O(n m) matmul work instead of the reference's O(n^2)
  row regeneration — the same "electronic-structure surrogate" character
  (dominant diagonal ~ orbital energies, small dense coupling) at any n,
  including the 10M-row north-star scale.
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

from fortran_davidson_tpu.ops.operators import MatrixFreeOperator
from fortran_davidson_tpu.utils.dtypes import canonical_dtype


def generate_diagonal_dominant(n: int, sparsity: float, diag_val=None,
                               key=None, dtype=jnp.float64):
    """Random dense symmetric diagonal-dominant matrix (test fixture)."""
    dtype = canonical_dtype(dtype)  # enables x64 when float64 is requested
    if key is None:
        key = jax.random.PRNGKey(0)
    arr = jax.random.uniform(key, (n, n), dtype=dtype) * sparsity
    arr = jnp.triu(arr, 1)
    arr = arr + arr.T
    if diag_val is None:
        diag = jnp.arange(1, n + 1, dtype=dtype)
    else:
        diag = jnp.full((n,), diag_val, dtype=dtype)
    return arr + jnp.diag(diag)


def bse_surrogate(n: int = 864, coupling: float = 5e-4, seed: int = 864,
                  dtype=jnp.float64):
    """Deterministic dense BSE-style regression matrix.

    Stands in for the reference's 864x864 Bethe-Salpeter fixture
    (``src/tests/test_reorder.f90:17-26``; the ``data/bse_singlet.dat``
    blob is absent from the mount, ``.MISSING_LARGE_BLOBS``): a dense
    symmetric matrix with the same character — clustered excitation-like
    diagonal in [0.3, 0.75] hartree with small dense coupling — used for
    the pinned-eigenvalue convergence regression (tier-1 test of
    SURVEY.md §4).
    """
    dt = canonical_dtype(dtype)
    rng = np.random.default_rng(seed)
    off = (rng.random((n, n)) - 0.5) * coupling
    off = np.triu(off, 1)
    off = off + off.T
    t = np.arange(n) / max(n - 1, 1)
    diag = 0.3 + 0.45 * t ** 1.2
    return jnp.asarray(off + np.diag(diag), dt)


def _rank2_trig_factors(n: int, dtype):
    """cos(t_i + t_j) = c_i c_j - s_i s_j with slowly-varying phases."""
    t = jnp.arange(n, dtype=dtype) * (2.0 * jnp.pi / max(n, 1)) * 0.37
    return jnp.cos(t), jnp.sin(t)


def low_rank_plus_diag_apply(X, diag, factors, weights):
    """Apply diag(d) + sum_r w_r u_r u_r^T (diagonal of the low-rank part
    removed, so `diag` is the exact operator diagonal)."""
    # Low-rank part: U (n, r); U^T X is (r, m) — two skinny matmuls.
    U = factors  # (n, r)
    coeff = jnp.dot(U.T, X, preferred_element_type=X.dtype)  # (r, m)
    low = jnp.dot(U * weights[None, :], coeff,
                  preferred_element_type=X.dtype)
    corr = jnp.sum((U * U) * weights[None, :], axis=1)  # low-rank diagonal
    return diag[:, None] * X + low - corr[:, None] * X


def low_rank_offdiag_apply_ds(x_hi, x_lo, diag, factors, weights):
    """Double-single off-diagonal apply: ``sum_r w_r u_r u_rᵀ`` minus its
    own diagonal, on ``x = x_hi + x_lo``, returned as ``(y_hi, y_lo)``.

    Why this exists: a plain f32 apply floors any residual measurement
    at the elementwise rounding of its OWN OUTPUT — ‖error‖ ~
    eps/2·‖A_off x‖ = eps/2·|w|·‖u‖·|uᵀx|, which at the 10M-row north
    star is ~1.4e-8, exactly at the 1e-8 convergence contract (observed:
    the final polish fixed-points there on unlucky pairs). Computing the
    skinny gram ``Uᵀx`` compensated (``gram_ds``) and carrying every
    product/add as an error-free transform pushes the floor to ~eps².
    ``diag`` (the off-diagonal operator's zero diagonal) is accepted so
    the signature matches the captured tuple of the f32 apply.

    SMALL-RANK ASSUMPTION: the compensated gram runs one Dot2 pass per
    factor column (each broadcasting that column to the full (n, k)
    block) and the reconstruction is an r-term outer-product cascade —
    O(r) full-size elementwise passes total. Fine for the surrogates' r <= 2;
    before reusing this as a generic DS apply for wide low-rank
    operators, batch the Dot2 gram across factors (two_prod on the
    broadcast product, one compensated reduction) so the pass count
    stops scaling with r.
    """
    from fortran_davidson_tpu.utils import ds as dsm

    U = factors  # (n, r)
    # Fully compensated skinny gram (r, k) in DS: Dot2 per factor
    # column (gram_ds's chunked-matmul compensation only kills the
    # ACROSS-chunk cancellation — its within-chunk f32 einsum still
    # rounds at ~eps·|partials|, which is the very floor this function
    # exists to remove). The lo channel's gram is first-order small —
    # a single f32 matmul suffices for it.
    g_rows = [dsm.dot_cols_ds(
        jnp.broadcast_to(U[:, r:r + 1], x_hi.shape), x_hi)
        for r in range(U.shape[1])]
    g = dsm.DS(jnp.stack([gr.hi for gr in g_rows]),
               jnp.stack([gr.lo for gr in g_rows]))
    g = dsm.ds_add(g, dsm.ds(jnp.dot(U.T, x_lo,
                                     preferred_element_type=x_lo.dtype)))
    p, e = dsm.two_prod(weights[:, None], g.hi)
    h_hi, h_lo = p, e + weights[:, None] * g.lo

    # y = U @ h as an exact r-term outer-product cascade (r is tiny).
    y_hi = None
    y_lo = jnp.zeros_like(x_hi)
    for r in range(U.shape[1]):
        p, e = dsm.two_prod(U[:, r:r + 1], h_hi[r:r + 1, :])
        if y_hi is None:
            y_hi = p
        else:
            y_hi, es = dsm.two_sum(y_hi, p)
            y_lo = y_lo + es
        y_lo = y_lo + e + U[:, r:r + 1] * h_lo[r:r + 1, :]

    # Remove the low-rank part's own diagonal exactly.
    corr = jnp.sum((U * U) * weights[None, :], axis=1)
    q, eq = dsm.two_prod(-corr[:, None], x_hi)
    y_hi, es = dsm.two_sum(y_hi, q)
    y_lo = y_lo + eq + es - corr[:, None] * x_lo
    return dsm.fast_two_sum(y_hi, y_lo)


def surrogate_hamiltonian(n: int, coupling: float = 1e-4,
                          dtype=jnp.float64) -> MatrixFreeOperator:
    """Matrix-free CI-matrix surrogate: A_ii = i+1,
    A_ij = coupling * cos(t_i + t_j) for i != j."""
    dt = canonical_dtype(dtype)
    c, s = _rank2_trig_factors(n, dt)
    diag = jnp.arange(1, n + 1, dtype=dt)
    U = jnp.stack([c, s], axis=1)  # (n, 2)
    w = jnp.asarray([coupling, -coupling], dt)

    def apply(X, diag, U, w):
        return low_rank_plus_diag_apply(X, diag, U, w)

    def offdiag_apply(X, diag, U, w):
        # Exact off-diagonal split for the refined-precision path: the
        # low-rank coupling with its own diagonal removed, no big-diag
        # cancellation anywhere.
        return low_rank_plus_diag_apply(X, jnp.zeros_like(diag), U, w)

    return MatrixFreeOperator(apply, n, dtype=dt, diag=diag,
                              captured=(diag, U, w),
                              offdiag_fn=offdiag_apply,
                              offdiag_ds_fn=low_rank_offdiag_apply_ds)


def surrogate_overlap(n: int, coupling: float = 1e-5,
                      dtype=jnp.float64) -> MatrixFreeOperator:
    """Matrix-free SPD overlap surrogate: B_ii = 1,
    B_ij = coupling * sin(t_i) sin(t_j) for i != j (rank-1, tiny norm =>
    strictly positive definite)."""
    dt = canonical_dtype(dtype)
    _, s = _rank2_trig_factors(n, dt)
    diag = jnp.ones((n,), dt)
    U = s[:, None]  # (n, 1)
    w = jnp.asarray([coupling], dt)

    def apply(X, diag, U, w):
        return low_rank_plus_diag_apply(X, diag, U, w)

    def offdiag_apply(X, diag, U, w):
        return low_rank_plus_diag_apply(X, jnp.zeros_like(diag), U, w)

    return MatrixFreeOperator(apply, n, dtype=dt, diag=diag,
                              captured=(diag, U, w),
                              offdiag_fn=offdiag_apply,
                              offdiag_ds_fn=low_rank_offdiag_apply_ds)

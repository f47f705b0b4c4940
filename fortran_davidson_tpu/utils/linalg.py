"""Small dense linear-algebra surface (lapack_wrapper parity).

Named equivalents of the reference's LAPACK wrapper routines
(``src/lapack_wrapper.f90:9-10``) for users who drove the reference
through that layer. All functions are jit-friendly jnp code; there is no
workspace-query dance, but the *error contract* survives: the eager
helpers raise :class:`NumericalError` naming the failing routine, the
way ``check_lapack_call`` aborts with the routine name
(``src/lapack_wrapper.f90:395-408``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from fortran_davidson_tpu.core.orthogonal import cholqr2
from fortran_davidson_tpu.utils.errors import NumericalError


def generalized_eigensolver(H, S=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """All eigenpairs, ascending — DSYEV / DSYGV(itype=1) semantics
    (``src/lapack_wrapper.f90:14-91``). With S, eigenvectors come back
    S-orthonormal exactly as DSYGV returns them."""
    if S is None:
        return jnp.linalg.eigh(H)
    L = jnp.linalg.cholesky(S)
    C1 = jax.scipy.linalg.solve_triangular(L, H, lower=True)
    C = jax.scipy.linalg.solve_triangular(L, C1.T, lower=True).T
    C = 0.5 * (C + C.T)
    w, Y = jnp.linalg.eigh(C)
    W = jax.scipy.linalg.solve_triangular(L.T, Y, lower=False)
    return w, W


def generalized_eigensolver_lowest(H, lowest: int, S=None):
    """Lowest-k eigenpairs — a WORKING replacement for the reference's
    dead DSYGVX wrapper (``src/lapack_wrapper.f90:93-174``, exported but
    never called, with an uninitialized ``abstol``)."""
    w, W = generalized_eigensolver(H, S)
    return w[:lowest], W[:, :lowest]


def qr_orthonormalize(X, method: str = "cholqr2"):
    """Orthonormal basis of span(X) — DGEQRF+DORGQR semantics
    (``src/lapack_wrapper.f90:176-236``); CholeskyQR2 by default (matmul
    shaped), ``method="qr"`` for Householder."""
    if method == "qr":
        q, _ = jnp.linalg.qr(X)
        return q
    q, _ = cholqr2(X)
    return q


def solve_symmetric(A, b, retry_jitter: bool = True):
    """Solve the symmetric (possibly indefinite) system A x = b — DSYSV
    semantics. Mirrors the reference's singular-pivot retry
    (``src/lapack_wrapper.f90:267-273``: substitute ``tiny()`` for a zero
    pivot): if the direct solve produces non-finite values, re-solve with
    a tiny diagonal regularization."""
    x = jnp.linalg.solve(A, b)
    if not retry_jitter:
        return x
    tiny = jnp.finfo(A.dtype).tiny ** 0.25
    scale = jnp.maximum(jnp.max(jnp.abs(A)), 1.0)
    A2 = A + tiny * scale * jnp.eye(A.shape[0], dtype=A.dtype)
    x2 = jnp.linalg.solve(A2, b)
    ok = jnp.all(jnp.isfinite(x))
    return jnp.where(ok, x, x2)


def sort_eigenpairs(w, V=None, ascending: bool = True):
    """Sort eigenvalues (and matching eigenvector columns) — DLASRT plus
    the reference's O(n^2) index-recovery scan
    (``src/lapack_wrapper.f90:367-392``), as one argsort."""
    order = jnp.argsort(w if ascending else -w)
    if V is None:
        return w[order]
    return w[order], V[:, order]


def check_finite(name: str, *arrays) -> None:
    """Eager error contract of ``check_lapack_call``
    (``src/lapack_wrapper.f90:395-408``): raise naming the routine."""
    for arr in arrays:
        if not bool(jnp.all(jnp.isfinite(arr))):
            raise NumericalError(
                f"Call to routine {name} produced non-finite values")

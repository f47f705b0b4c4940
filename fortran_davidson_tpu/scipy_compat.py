"""scipy.sparse.linalg-compatible entry point.

The reference's users cross-validate against scipy
(``src/tests/test_davidson.py:15-51`` drives ``scipy.linalg.eigh``);
users migrating a scipy workflow get the same call shape here:

    from fortran_davidson_tpu.scipy_compat import eigsh
    w, v = eigsh(A, k=6, which="SA", tol=1e-8)

Supported: symmetric/Hermitian-real operators (dense arrays,
``scipy.sparse`` matrices, any :class:`LinearOperator` of this package),
generalized pencils via ``M``, ``which in ("SA", "LA", "LM", "SM", "BE")``,
``sigma`` interior targets, ``v0`` warm starts,
``maxiter``/``tol``/``ncv``.

Largest-algebraic ("LA") solves ride the spectral flip -A;
largest-magnitude ("LM") merges both spectrum ends. Interior targets
(``sigma``, and "SM" = sigma 0) use the SPECTRAL FOLD rather than
scipy's shift-invert: Davidson runs on ``(A - σ)²`` — two operator
applies per block, no factorization or linear solves, so the transform
is matrix-free and accelerator-friendly (shift-invert's sparse LU has
no efficient accelerator analogue). Eigenvalues are recovered as Rayleigh
quotients of the returned vectors and every pair is re-checked against
the TRUE residual ``||A x - λ x||``, with warm-started re-solves at
tightened fold tolerances until the user's ``tol`` holds — folding
squares the spectrum, so the honest convergence contract lives on the
unfolded residual, not the folded solve's.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

import jax

from fortran_davidson_tpu.ops.operators import LinearOperator, as_operator
from fortran_davidson_tpu.solver import eigensolve
from fortran_davidson_tpu.utils.errors import (InvalidOptionsError,
                                               OperatorError, require)


@jax.tree_util.register_pytree_node_class
class _Negated(LinearOperator):
    """-A as an operator (spectral flip for which='LA')."""

    def __init__(self, op: LinearOperator):
        self._op = op

    @property
    def shape(self):
        return self._op.shape

    @property
    def dtype(self):
        return self._op.dtype

    def matmat(self, block):
        return -self._op.matmat(block)

    def diagonal(self):
        return -self._op.diagonal()

    def offdiag(self):
        return _Negated(self._op.offdiag())

    def tree_flatten(self):
        return (self._op,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])


@jax.tree_util.register_pytree_node_class
class _ShiftFolded(LinearOperator):
    """The spectral fold ``(A - σI)²``: eigenvalues ``(λ - σ)²``, SAME
    eigenvectors — the smallest folded eigenvalues belong to the λ
    nearest σ. Two applies of A per block, no factorization.

    ``diagonal()`` returns the diagonal-dominant approximation
    ``(d - σ)²`` (the exact ``diag((A-σ)²)`` needs row sum-squares the
    generic operator cannot provide). The solver uses the diagonal only
    as the DPR/GJD preconditioner, and the generic ``offdiag`` fallback
    computes ``matmat(x) - diagonal()·x`` — self-consistent, so
    residuals and Rayleigh quotients on the folded operator stay exact
    regardless of the approximation.
    """

    def __init__(self, op: LinearOperator, sigma):
        self._op = op
        self._sigma = sigma

    @property
    def shape(self):
        return self._op.shape

    @property
    def dtype(self):
        return self._op.dtype

    def matmat(self, block):
        y = self._op.matmat(block) - self._sigma * block
        return self._op.matmat(y) - self._sigma * y

    def diagonal(self):
        return (self._op.diagonal() - self._sigma) ** 2

    def tree_flatten(self):
        return (self._op, self._sigma), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def _folded_solve(op, k, sigma, tol, kw):
    """Davidson on the fold + honest unfolded convergence contract.

    Solves lowest-k of ``(A-σ)²`` at a fold tolerance, recovers
    ``λ_j = x_jᵀ A x_j`` and TRUE residuals ``||A x - λ x||``, and
    re-solves warm-started at tightened fold tolerances until the true
    residuals meet ``tol`` (folding squares the spectrum, so no single
    fold tolerance maps onto the user's bound a priori).
    """
    fold = _ShiftFolded(op, jnp.asarray(sigma, op.dtype))
    kw = dict(kw)
    kw.pop("tolerance", None)
    x0 = kw.pop("initial_vectors", None)
    res = None
    fold_tol = float(tol)
    # Every folded eigenvalue is a (near-)double — λ = σ±δ fold to the
    # same (δ²) level — so the k-th folded vector can capture only HALF
    # of a pair, mixing two A-eigenvectors. One extra column keeps the
    # boundary pair whole; the k pairs nearest σ are selected after the
    # Rayleigh-Ritz below.
    k_f = min(k + 1, op.shape[0])
    theta = X = r = near = None
    for _ in range(4):
        res = eigensolve(fold, k_f, tolerance=fold_tol,
                         initial_vectors=x0, **kw)
        Xf = jnp.asarray(res.eigenvectors)
        # Rayleigh-Ritz of A (not the fold) on the folded subspace:
        # within each near-degenerate folded pair the individual
        # eigenvectors are arbitrary rotations mixing the two
        # A-eigenvectors. The SPAN is still right; diagonalizing
        # Q^T A Q over it separates them. The unfold runs at full f32
        # matmul precision — a platform default that demotes f32
        # operands would put ~1e-3-relative noise under theta and r,
        # making the honest tol re-check below unpassable.
        with jax.default_matmul_precision("highest"):
            Q = jnp.linalg.qr(Xf)[0]
            AQ = op.matmat(Q)
            theta, U = jnp.linalg.eigh(Q.T @ AQ)
            X, AX = Q @ U, AQ @ U
            r = jnp.linalg.norm(AX - X * theta[None, :], axis=0)
        near = jnp.argsort(jnp.abs(theta - sigma))[:k]
        near = near[jnp.argsort(theta[near])]  # ascending, scipy order
        if bool(jnp.all(r[near] <= tol)):
            return (np.asarray(theta[near]), np.asarray(X[:, near]),
                    np.asarray(r[near]))
        x0, fold_tol = X, fold_tol * 1e-2
    # Honest failure: expose UNFOLDED quantities (A's Rayleigh-Ritz
    # values/vectors from the last round and their true residuals), not
    # the folded solve's (λ-σ)² internals.
    raise ArpackNoConvergence(
        _UnfoldedPartial(
            eigenvalues=np.asarray(theta[near]),
            eigenvectors=np.asarray(X[:, near]),
            converged_pairs=np.asarray(r[near] <= tol),
            iterations=res.iterations,
            residual_norms=np.asarray(r[near]),
            fold_result=res),
        k)


class _UnfoldedPartial:
    """Result-shaped view for :class:`ArpackNoConvergence` after a
    failed spectral-fold solve: eigenvalues/vectors/residuals are in
    A's spectrum (post Rayleigh-Ritz unfold); the raw folded-solve
    result rides on ``.fold_result``."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def eigsh(A, k: int = 6, M=None, sigma=None, which: Optional[str] = None,
          v0=None, ncv: Optional[int] = None, maxiter: Optional[int] = None,
          tol: float = 0.0, return_eigenvectors: bool = True,
          dtype=None, **overrides):
    """Lowest/largest-k symmetric eigenpairs, scipy-call-shaped.

    Args mirror ``scipy.sparse.linalg.eigsh`` where the semantics map
    onto block Davidson:

      A, M: operator and optional pencil B — anything
        :func:`as_operator` accepts (dense, ``scipy.sparse``, this
        package's operators, callables are NOT guessed — wrap those in
        :class:`MatrixFreeOperator`).
      k: number of eigenpairs.
      which: "SA" (smallest algebraic — the Davidson native target),
        "LA" (largest algebraic, solved as the smallest of -A; with a
        pencil the flip is applied to A only, which preserves the
        generalized eigenvectors and negates the eigenvalues),
        "LM" (largest magnitude: both spectrum ends solved, k largest
        |λ| kept), or "SM" (smallest magnitude: the spectral fold at
        σ=0 — standard problems only).
      sigma: interior target — the k eigenpairs nearest ``sigma`` via
        the spectral fold ``(A-σ)²`` (see module docstring; standard
        problems only; ``which`` must be "LM", scipy's shift-invert
        default, meaning nearest-σ).
      v0: (n,) or (n, j) warm-start vector(s).
      ncv: maximum working-subspace dimension (``max_dim_sub``).
      maxiter: outer-iteration cap (default: the solver's 1000).
      tol: convergence tolerance; scipy's 0 sentinel maps to 1e-8
        (the reference default) rather than machine precision.
      return_eigenvectors: scipy contract — (w, v) or w alone.
      **overrides: any :class:`DavidsonOptions` field (method="GJD",
        refined=True, ...).

    Returns eigenvalues ascending (scipy's eigsh order) and, when
    requested, the corresponding eigenvectors.
    """
    if which is None:
        # scipy's default is "LM"; without sigma the Davidson-native
        # smallest-algebraic is this package's default, with sigma the
        # nearest-σ reading is the only sensible one.
        which = "LM" if sigma is not None else "SA"
    require(which in ("SA", "LA", "LM", "SM", "BE"), InvalidOptionsError,
            f"which={which!r} not supported (use 'SA', 'LA', 'LM', 'SM' "
            "or 'BE')")
    op = as_operator(A, dtype=dtype)
    B = None if M is None else as_operator(M, dtype=dtype)

    kw = dict(overrides)
    if ncv is not None:
        kw.setdefault("max_dim_sub", int(ncv))
    if maxiter is not None:
        kw.setdefault("max_iterations", int(maxiter))
    kw.setdefault("tolerance", float(tol) if tol else 1e-8)
    if v0 is not None:
        v0 = jnp.asarray(v0)
        if v0.ndim == 1:
            v0 = v0[:, None]
        kw.setdefault("initial_vectors", v0)

    if sigma is not None or which == "SM":
        require(B is None, InvalidOptionsError,
                "sigma/'SM' (spectral fold) supports standard problems "
                "only: fold a pencil by pre-transforming it, or use "
                "eigensolve directly")
        require(sigma is None or which == "LM", InvalidOptionsError,
                "with sigma, which must be 'LM' (scipy's shift-invert "
                "default: eigenvalues nearest sigma)")
        tol_eff = float(kw.pop("tolerance"))
        w, v, _ = _folded_solve(op, k, 0.0 if sigma is None else sigma,
                                tol_eff, kw)
        return (w, v) if return_eigenvectors else w

    if which in ("LM", "BE"):
        # Both-ends solves: lowest of (A, B) (left end) and of (-A, B)
        # (right end — the flip negates pencil eigenvalues and
        # preserves eigenvectors). "LM" keeps the k largest |λ| of the
        # merged set; "BE" keeps half from each end, odd k giving the
        # extra pair to the HIGH end (scipy's convention).
        k_lo = k if which == "LM" else k // 2
        k_hi = k if which == "LM" else -(-k // 2)
        require(k_lo + k_hi <= op.shape[0], InvalidOptionsError,
                f"which={which!r} solves both spectrum ends and needs "
                "their pair counts to fit n")
        lo = eigensolve(op, max(k_lo, 1), second_matrix=B, **kw)
        hi = eigensolve(_Negated(op), max(k_hi, 1), second_matrix=B,
                        **kw)
        if not (bool(lo.converged) and bool(hi.converged)):
            raise ArpackNoConvergence(lo if not bool(lo.converged)
                                      else hi, k)
        w = np.concatenate([np.asarray(lo.eigenvalues)[:k_lo],
                            -np.asarray(hi.eigenvalues)[:k_hi]])
        v = np.concatenate([np.asarray(lo.eigenvectors)[:, :k_lo],
                            np.asarray(hi.eigenvectors)[:, :k_hi]],
                           axis=1)
        if which == "LM":
            keep = np.argsort(-np.abs(w), kind="stable")[:k]
        else:
            keep = np.arange(w.size)
        keep = keep[np.argsort(w[keep], kind="stable")]  # ascending
        return (w[keep], v[:, keep]) if return_eigenvectors else w[keep]

    flip = which == "LA"
    if flip:
        op = _Negated(op)
    res = eigensolve(op, k, second_matrix=B, **kw)
    if not bool(res.converged):
        raise ArpackNoConvergence(res, k)
    w = np.asarray(res.eigenvalues)
    v = np.asarray(res.eigenvectors)
    if flip:
        w = -w[::-1]
        v = v[:, ::-1]
    return (w, v) if return_eigenvectors else w


class ArpackNoConvergence(RuntimeError):
    """Raised when the solve does not converge (scipy's eigsh raises its
    ARPACK equivalent). The partial result rides on ``.result``; the
    converged subset on ``.eigenvalues``/``.eigenvectors`` (scipy
    contract)."""

    def __init__(self, result, k: int):
        conv = np.asarray(result.converged_pairs)
        self.result = result
        self.eigenvalues = np.asarray(result.eigenvalues)[conv]
        self.eigenvectors = np.asarray(result.eigenvectors)[:, conv]
        super().__init__(
            f"Davidson did not converge all {k} pairs in "
            f"{int(result.iterations)} iterations "
            f"({int(conv.sum())} converged); inspect .result, or retry "
            "with refined=True / a larger maxiter")

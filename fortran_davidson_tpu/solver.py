"""Public solver API.

Replaces the reference's generic interface ``generalized_eigensolver``
(``src/davidson.f90:601-625``) — which dispatches on dense-matrix vs
callable argument types at compile time — with a single function accepting
any :class:`~fortran_davidson_tpu.ops.operators.LinearOperator` (dense
arrays are coerced automatically). Unlike the reference:

- the matrix-free path supports the *standard* problem and GJD (the
  reference's free engine is generalized-only and DPR-only,
  ``src/davidson.f90:277-279,428``);
- unknown method strings raise instead of returning garbage;
- the result carries convergence history and per-pair status.
"""

from __future__ import annotations

import warnings
from typing import Optional

import jax.numpy as jnp

from fortran_davidson_tpu.config import (DavidsonOptions, DavidsonResult,
                                         merge_options, operator_nbytes,
                                         resolve_options,
                                         validate_initial_vectors)
from fortran_davidson_tpu.core.loop import get_engine
from fortran_davidson_tpu.ops.operators import LinearOperator, as_operator
from fortran_davidson_tpu.utils.dtypes import canonical_dtype
from fortran_davidson_tpu.utils.errors import OperatorError, require


def eigensolve(matrix, lowest: int, second_matrix=None,
               options: Optional[DavidsonOptions] = None,
               initial_vectors=None,
               **overrides) -> DavidsonResult:
    """Compute the lowest-k eigenpairs of a (generalized) symmetric problem.

    Args:
      matrix: operator A — a LinearOperator, a dense (n, n) array, or a
        1-D diagonal.
      lowest: number of lowest eigenpairs to compute.
      second_matrix: optional operator B for the pencil ``A x = lambda B x``
        (same accepted types). ``None`` selects the standard problem.
      options: DavidsonOptions; keyword overrides are applied on top, e.g.
        ``eigensolve(A, 3, method="GJD", tolerance=1e-6)``.
      initial_vectors: optional (n, j) warm-start block, ``j <= init_dim``
        (default init_dim = 2*lowest) — e.g. the eigenvectors of a
        previous solve of a slowly varying operator (the production
        repeated-solve pattern; the reference has no analogue,
        ``src/array_utils.f90:136-160`` always starts from unit
        vectors). The block is SVQB-orthonormalized together with the
        canonical preconditioner fill; redundant/rank-deficient guesses
        degrade gracefully to the cold start.

    Returns:
      DavidsonResult.
    """
    opts = merge_options(options, overrides)
    dt = canonical_dtype(opts.dtype)

    A = as_operator(matrix, dtype=dt)
    B = None if second_matrix is None else as_operator(second_matrix, dtype=dt)
    require(A.shape[0] == A.shape[1], OperatorError, "A must be square")
    if B is not None:
        require(B.shape == A.shape, OperatorError,
                f"B shape {B.shape} does not match A shape {A.shape}")

    cfg = resolve_options(opts, lowest, A.shape[0], generalized=B is not None,
                          operator_bytes=operator_nbytes(A, B))
    if (opts.fused_gram == "on" and B is None and not cfg.refined
            and cfg.expansion == "lowest-k"
            and jnp.dtype(cfg.dtype) == jnp.float32
            and hasattr(A, "matmat_with_gram")):
        # Incremental-H engine: the expand block's projection columns
        # come from the operator's ``matmat_with_gram`` (see
        # DavidsonOptions.fused_gram; "auto" would engage it only for an
        # operator with a fused SpMM+Gram kernel, and none has one).
        # Capability is an operator property, so the flag resolves here,
        # not in resolve_options.
        import dataclasses
        cfg = dataclasses.replace(cfg, fused_gram=True)
    X0 = validate_initial_vectors(initial_vectors, A.shape[0],
                                  cfg.init_dim, dt)
    engine = get_engine(cfg)
    if cfg.refined:
        # High-precision path: the engine additionally receives the
        # off-diagonal splits (structural for sparse formats — see
        # LinearOperator.offdiag) used for compensated true residuals.
        return engine(A, B, A.offdiag(), B.offdiag() if B else None,
                      X0=X0)
    return engine(A, B, X0=X0)


def polish_eigenpairs(matrix, result: DavidsonResult, iterations: int = 3,
                      second_matrix=None, dtype=None,
                      update: str = "dpr"):
    """Double-single post-refinement of a solve's eigenpairs.

    f32 storage of an eigenvector floors its attainable residual at
    ~eps*|d ∘ x| — this pass re-iterates the k returned pairs with the
    vectors held as double-single (hi+lo f32 pairs) and all diagonal
    cancellations in exact compensated arithmetic, converging absolute
    residuals to the reference's real64 regime (1e-8 and below) for
    diagonal-dominant operators. See :func:`core.refine.polish`.

    Returns a ``core.refine.PolishResult`` (evals, evecs_hi, evecs_lo,
    errors). ``evecs_hi + evecs_lo`` is the f64-grade eigenvector; use
    ``evecs_hi`` alone where a plain f32 array is needed.
    """
    from fortran_davidson_tpu.core.refine import polish

    dt = canonical_dtype(dtype or result.eigenvectors.dtype)
    A = as_operator(matrix, dtype=dt)
    B = None if second_matrix is None else as_operator(second_matrix,
                                                       dtype=dt)
    return polish(
        A.offdiag(), A.diagonal(), result.eigenvalues, result.eigenvectors,
        iterations=iterations,
        B_off=None if B is None else B.offdiag(),
        diag_b=None if B is None else B.diagonal(),
        update=update)


def generalized_eigensolver(matrix, lowest: int, method: str = "DPR",
                            max_iterations: int = 1000,
                            tolerance: float = 1e-8,
                            max_dim_sub: Optional[int] = None,
                            second_matrix=None,
                            **overrides) -> DavidsonResult:
    """Reference-flavored entry point (argument names follow
    ``src/davidson.f90:51-52``). Eager: blocks on the result and emits the
    reference's non-convergence warning (``src/davidson.f90:232-235``)."""
    res = eigensolve(matrix, lowest, second_matrix=second_matrix,
                     method=method, max_iterations=max_iterations,
                     tolerance=tolerance, max_dim_sub=max_dim_sub,
                     **overrides)
    res.block_until_ready()
    if not bool(res.converged):
        # The hint must reflect the RESOLVED configuration: `refined`
        # may arrive via options=DavidsonOptions(refined=True) rather
        # than as a keyword override, and suggesting refined=True to a
        # solve that already ran refined would be misleading.
        resolved = merge_options(
            overrides.get("options"),
            {key: v for key, v in overrides.items() if key != "options"})
        hint = ""
        if (jnp.dtype(res.eigenvalues.dtype) == jnp.float32
                and not resolved.refined
                and tolerance < 1e-5):
            hint = (" — float32 residuals floor at ~sqrt(n)*eps*||A||; "
                    "for tighter tolerances use refined=True (+"
                    "final_polish) or relative_tolerance=True")
        warnings.warn("Davidson algorithm did not converge "
                      f"within {max_iterations} iterations "
                      f"(residuals: {res.residual_norms}){hint}",
                      RuntimeWarning, stacklevel=2)
    return res

"""Batched Davidson: many independent problems in ONE compiled program.

The reference solves one pencil per program invocation (its drivers call
``generalized_eigensolver`` on a single matrix, ``src/davidson.f90:
601-625``); screening workloads — parameter sweeps, k-point samplings,
per-molecule Hamiltonians — then pay a full program launch and leave the
matmul units idle on every small solve. On an accelerator the economics
invert: ``vmap`` of
the whole padded while-loop engine over a leading batch axis turns every
Gram matmul, projected eigh, and operator application into one batched
op across the fleet of problems, and XLA compiles exactly one
program. This is only possible because the engine was designed
fixed-shape from the start (padded basis, masked activity, ``lax.cond``
branches) — the batching rule masks per-problem state updates by each
problem's own exit condition, so every problem keeps its individual
iteration count, convergence flags, and history.

Semantics per batch element match :func:`fortran_davidson_tpu.eigensolve`
exactly (same engine, same schedule); the returned
:class:`~fortran_davidson_tpu.config.DavidsonResult` simply carries a
leading batch axis on every leaf.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from fortran_davidson_tpu.config import (DavidsonOptions, DavidsonResult,
                                         merge_options, resolve_options)
from fortran_davidson_tpu.core.loop import _LRUCache, _engine
from fortran_davidson_tpu.utils.dtypes import canonical_dtype
from fortran_davidson_tpu.utils.errors import (InvalidOptionsError,
                                               OperatorError, require)

_BATCHED_CACHE = _LRUCache(16)


def _make_runner(cfg, diag_a: bool, diag_b: Optional[bool], has_x0: bool):
    """One-problem solver with a positional-only signature (vmap needs
    every argument to be an array; None/optional args are resolved
    statically here)."""
    from fortran_davidson_tpu.ops.operators import (DenseOperator,
                                                    DiagonalOperator)

    def wrap(arr, diag):
        return DiagonalOperator(arr) if diag else DenseOperator(arr)

    def run_one(*args):
        i = 0
        A = wrap(args[i], diag_a); i += 1
        B = None
        if diag_b is not None:
            B = wrap(args[i], diag_b); i += 1
        X0 = args[i] if has_x0 else None
        if cfg.refined:
            return _engine(cfg, A, B, A_off=A.offdiag(),
                           B_off=None if B is None else B.offdiag(), X0=X0)
        return _engine(cfg, A, B, X0=X0)

    return run_one


def eigensolve_batched(matrices, lowest: int, second_matrices=None,
                       options: Optional[DavidsonOptions] = None,
                       initial_vectors=None,
                       **overrides) -> DavidsonResult:
    """Solve a batch of independent symmetric (generalized) eigenproblems.

    Args:
      matrices: stacked operators A — ``(b, n, n)`` dense matrices or
        ``(b, n)`` diagonals.
      lowest: number of lowest eigenpairs per problem.
      second_matrices: optional stacked B for the pencils (same accepted
        shapes; may mix kinds with A, e.g. dense A with diagonal B).
      options / overrides: as :func:`~fortran_davidson_tpu.eigensolve`.
        ``carry_layout`` resolves to ``"flat"`` (the chunked layout is a
        single-LARGE-problem optimization); requesting ``"chunked"``
        explicitly raises.
      initial_vectors: optional ``(b, n, j)`` per-problem warm starts.

    Returns:
      DavidsonResult whose leaves carry a leading batch axis: eigenvalues
      ``(b, k)``, eigenvectors ``(b, n, k)``, iterations ``(b,)``, etc.
      Each problem runs its own schedule; a problem that converges early
      stops updating (its iteration count is its own), while the fused
      program runs until the slowest problem exits.
    """
    opts = merge_options(options, overrides)
    require(opts.carry_layout != "chunked", InvalidOptionsError,
            "eigensolve_batched: carry_layout='chunked' is a single-"
            "large-problem layout; use the default")
    if opts.carry_layout == "auto":
        import dataclasses
        opts = dataclasses.replace(opts, carry_layout="flat")
    dt = canonical_dtype(opts.dtype)

    A = jnp.asarray(matrices, dt)
    require(A.ndim in (2, 3), OperatorError,
            "matrices must be (b, n, n) dense or (b, n) diagonals, got "
            f"shape {A.shape}")
    diag_a = A.ndim == 2
    require(diag_a or A.shape[1] == A.shape[2], OperatorError,
            f"batched matrices must be square, got {A.shape}")
    b, n = A.shape[0], A.shape[1]

    args = [A]
    in_axes = [0]
    diag_b = None
    if second_matrices is not None:
        Bm = jnp.asarray(second_matrices, dt)
        require(Bm.ndim in (2, 3) and Bm.shape[0] == b
                and Bm.shape[1] == n
                and (Bm.ndim == 2 or Bm.shape[2] == n), OperatorError,
                f"second_matrices shape {Bm.shape} does not match "
                f"matrices {A.shape}")
        diag_b = Bm.ndim == 2
        args.append(Bm)
        in_axes.append(0)

    cfg = resolve_options(opts, lowest, n, generalized=diag_b is not None)

    has_x0 = initial_vectors is not None
    if has_x0:
        X0 = jnp.asarray(initial_vectors, dt)
        require(X0.ndim == 3 and X0.shape[0] == b and X0.shape[1] == n
                and 1 <= X0.shape[2] <= cfg.init_dim, OperatorError,
                "initial_vectors must be (b, n, j) with j <= init_dim="
                f"{cfg.init_dim}; got {X0.shape}")
        args.append(X0)
        in_axes.append(0)

    key = (cfg, diag_a, diag_b, has_x0)
    fn = _BATCHED_CACHE.get(key)
    if fn is None:
        run_one = _make_runner(cfg, diag_a, diag_b, has_x0)
        fn = jax.jit(jax.vmap(run_one, in_axes=tuple(in_axes)))
        _BATCHED_CACHE.put(key, fn)
    return fn(*args)

"""Solver options and results.

The reference passes every knob as a positional subroutine argument
(``src/davidson.f90:51-52``); here they are a frozen dataclass (hashable, so
compiled engines are cached per configuration). Defaults mirror the
reference's hidden defaults: initial subspace ``2 * lowest``
(``src/davidson.f90:108``), maximum subspace ``10 * lowest``
(``src/davidson.f90:115-119``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import jax.numpy as jnp
import numpy as np

from fortran_davidson_tpu.core.correction import validate_method
from fortran_davidson_tpu.utils.errors import InvalidOptionsError, require


@dataclasses.dataclass(frozen=True)
class DavidsonOptions:
    """User-facing solver knobs.

    Attributes:
      method: correction scheme, "DPR", "GJD", or "OLSEN" (validated; the
        reference silently misbehaves on unknown strings,
        ``src/davidson.f90:653-669``). OLSEN is DPR plus the skew
        projection that keeps the correction orthogonal to the Ritz
        vector — same cost class as DPR, immune to DPR's stagnation when
        λ sits on a diagonal entry (beyond the reference).
      max_iterations: outer-iteration cap.
      tolerance: 2-norm residual tolerance per eigenpair.
      max_dim_sub: maximum subspace dimension before collapse
        (default ``10 * lowest``, reference ``src/davidson.f90:115-119``).
        At large row counts the default is additionally clamped so the
        tall carries fit the per-device memory budget (see
        :func:`device_budget_bytes`; ``FDT_CARRY_BUDGET_BYTES``
        overrides) and, for float32, to the widest basis measured to
        converge (``_F32_MAX_BASIS_ENTRIES``: 10M rows at 64 columns).
        The clamp descends the 4-wide lattice from
        ``10 * lowest`` and floors at ``init_dim + 4`` (the expansion
        must still fire; a ``max_dim == init_dim`` basis collapses every
        other iteration).
      init_dim: initial subspace dimension (default ``2 * lowest``).
      sticky_convergence: if True, a pair that once converged stays
        converged (dense-engine semantics, ``src/davidson.f90:173-178``);
        if False, all pairs are re-checked every iteration (matrix-free
        engine semantics, ``src/davidson.f90:416``).
      gjd_inner_iters: MINRES iteration cap for the GJD correction solve;
        ``None`` chooses ``min(n, 128)`` (effectively exact for the small
        parity problems, bounded for large ones).
      gjd_inner_tol: relative residual tolerance of the inner GJD solve.
        With the adaptive schedule (below) this is the FLOOR — the
        tightest the inner solve is ever asked to go.
      gjd_inner_schedule: "adaptive" (default) adds an outer-target
        forcing term to the inner stop (inexact Jacobi-Davidson):
        ``rtol_j = clip(0.01 * tolerance / ||r_j||, gjd_inner_tol,
        1e-2)`` — the inner solve never works past the point where its
        residual is invisible against the outer convergence test (1%
        relative, or 1% of the outer tolerance absolute). Chosen by
        measurement: schedules linked to the current outer residual
        (eta ~ ||r|| or ||r||²) and looser endgame caps (0.1-0.5) both
        cost outer iterations, which at scale are the expensive
        currency. "fixed" uses ``gjd_inner_tol`` unconditionally.
        Either way the inner MINRES stops early at its floating-point
        attainable floor (a per-column no-progress cutoff — the
        dominant saving at f32 scale, where late outer steps otherwise
        grind the full inner cap with a flat residual).
      gjd_preconditioner: "none" (reference semantics — the reference's
        GJD has no preconditioning), "dpr" (floored symmetric diagonal
        scaling of the correction equation; can cut inner MINRES
        iterations on strongly diagonal-dominant operators, but may slow
        outer convergence when Ritz values sit close to diagonal
        entries — benchmark per problem), or "olsen" (the projected
        Jacobi-Davidson preconditioner in warm-start form: the inner
        MINRES runs on the exact unscaled projected operator but starts
        from the Olsen correction and stops at the original absolute
        target — measurably fewer inner iterations at unchanged outer
        semantics). At scale precondition: with a bounded inner budget
        on an ill-conditioned operator (condition ~ n for the diag ~ 1..n
        surrogates), unpreconditioned inner MINRES cannot reduce the
        correction residual and the outer loop stalls (observed at 1M
        rows f32: "none" stalls at 40 iterations while "dpr" converges in
        2 and "olsen" in 3).
      gjd_warm_start: recycle each outer iteration's raw GJD correction
        block as the next iteration's inner-solve initial guess (solve
        ``op δ = rhs - op(t_prev)``, ``t = t_prev + δ``, stopped at the
        ORIGINAL system's absolute target). Complements — and when a
        previous correction exists, takes precedence over — the Olsen
        warm start of ``gjd_preconditioner="olsen"``. The same overshoot
        guard scales a stale guess back toward a cold start, so the
        outer trajectory is preserved up to inner-tolerance-level
        roundoff; costs one extra block operator application per outer
        iteration (the residual of the guess) plus an (n, k)-block
        carry. Off by default (exact reference-schedule parity).
      n_reorth: CGS passes when orthogonalizing new blocks (2 = CGS2).
      relative_tolerance: if True, pair j converges when
        ``||r_j|| < tolerance * max(|lambda_j|, 1)`` instead of the
        reference's absolute check (``src/davidson.f90:174``) — needed for
        float32 solves at scale, where the absolute residual floor grows
        with ||A||.
      orthonormalization: "cholqr2" (CholeskyQR2 — Gram matmul + small
        Cholesky, all matmul/psum work) or "qr" (Householder
        ``jnp.linalg.qr``, the reference's DGEQRF semantics; slower at
        tall-skinny shapes).
      expansion: "doubling" (the reference schedule — the correction
        block has as many columns as the basis, so dimensions go
        init, 2*init, 4*init, ... ``src/davidson.f90:199``; required for
        iteration-count parity) or "lowest-k" (classic Davidson — expand
        by corrections for the k wanted pairs only; a much smaller
        padded width for large k, e.g. lowest-20 with max_dim 200:
        doubling pads to 320 columns, lowest-k to 220).
      dtype: float64 (reference parity) or float32.
      refined: enable the double-single high-precision path (f32
        storage and arithmetic reaching the reference's real64-grade
        accuracy):
        compensated Gram matrices in orthonormalization and projection,
        true residuals with the diagonal cancellation in exact
        two_prod/two_sum arithmetic (one extra off-diagonal operator
        application on the k wanted columns per iteration), and
        Rayleigh-refined reported eigenvalues. See ``core.refine``.
      final_polish: number of double-single polish iterations applied to
        the k returned eigenpairs INSIDE the solve (requires
        ``refined=True``). f32 basis storage floors the loop's attainable
        residual (~3.5e-5 absolute at 10M rows, measured); the polish
        holds the k vectors as hi/lo f32 pairs, beating that floor by
        orders of magnitude (1e-11-grade true residuals), and convergence
        is re-evaluated against the POLISHED true residuals — so
        ``tolerance=1e-8`` solves of 10M-row f32 problems report
        ``converged=True`` honestly. Cost: one off-diagonal operator
        application on 2k columns per polish iteration. The returned
        eigenvectors are the polished hi words; use
        :func:`solver.polish_eigenpairs` directly when the lo words are
        needed.
      polish_update: the polish's per-coordinate update — "dpr"
        (floored Jacobi/DPR, the default) or "olsen" (Olsen-projected
        update with near-exact denominators; cures the DPR fixed point
        when an eigenvalue falls within the denominator floor of a
        diagonal entry — see ``core.refine.polish``).
      cheb_degree: degree of the Chebyshev filter applied to the restart
        block at every subspace collapse (0 = off, the reference
        schedule ``src/davidson.f90:218``; >= 2 enables ChASE-style
        filtered restarts, ``core.chebyshev``). Each collapse then costs
        ``degree + 1`` extra block operator applications (on ``init_dim``
        columns) and damps the unwanted spectral components
        exponentially in the degree — worth it for large k or slowly
        converging spectra where collapses discard hard-won information.
        ``"auto"`` picks the degree per collapse from the measured
        spectral geometry (``core.chebyshev.auto_degree``: the smallest
        degree achieving ~1e3 wanted-vs-damped amplification given the
        current Ritz gap, capped at 12) — well-separated spectra get a
        cheap filter, clustered ones don't burn unbounded applications.
        Standard problems only (the filter is a polynomial in A alone).
      matmul_precision: XLA matmul precision for the whole solver trace
        (``jax.default_matmul_precision``). ``None`` (default) resolves
        to ``"float32"`` for float32 solves and leaves the platform
        default otherwise. A platform default that demotes f32 operands
        (TF32 on GPU tensor cores, 10-bit mantissa) is poisonous for an
        eigensolver: the projected matrix, Ritz products, residuals, and
        the GJD inner Krylov all inherit the operand noise (observed: the
        GJD Olsen warm start at 1M rows f32 diverges under bf16-grade
        operands and converges in a handful of iterations at f32
        precision). The solver is memory-bound at the tall-skinny shapes
        that dominate, so full-precision products cost little. Set
        ``"tensorfloat32"`` or ``"bfloat16"`` explicitly to trade
        accuracy for matmul throughput.
      locking: freeze (deflate) converged eigenpairs out of the
        correction/expansion block — their Ritz vectors stay in the
        basis (so their eigenvalues keep being reported exactly), but no
        new correction columns are spent on them. With k pairs of
        spread-out difficulty this cuts the operator columns applied per
        expansion (see ``DavidsonResult.operator_columns``). Off by
        default: the reference corrects every pair every iteration
        (``src/davidson.f90:199``), and iteration-count parity requires
        that schedule.
      carry_layout: storage layout of the tall basis/cache carries
        (V, AV, BV) inside the solver loop. ``"flat"`` keeps
        ``(n, m_max)``; ``"chunked"`` stores them pre-chunked as
        ``(n/c, c, m_max)`` — the exact layout the compensated Gram's
        batched einsum consumes — so the ``(n, m) -> (n/c, c, m)``
        relayout copies of the refined iteration never appear in the
        graph. Every consumer contracts with the same
        per-element order, so trajectories are BIT-IDENTICAL to the
        flat layout (tests pin this). Requires ``refined=True``. Under
        the GSPMD sharded engine (round 5) chunks are sized to divide
        the per-shard row count so the chunked carries row-shard on
        chunk boundaries — bit-identical to flat sharding whenever the
        default chunk already divides the shard (otherwise the smaller
        shard-aligned chunk changes bits, same accuracy class).
        ``"auto"`` (default) picks ``"chunked"`` whenever the
        requirements hold and the row count admits a useful chunk.
      fused_gram: ``"on"`` runs the incremental-H engine: the projected
        matrix H = VᵀAV is carried in the loop state and each
        expansion's new columns come from the operator's
        ``matmat_with_gram`` (``G = Vᵀ(AQ)``), replacing the
        per-iteration full Gram recomputation (reference gemms
        ``src/davidson.f90:131,380``). Applies to float32,
        standard-problem, lowest-k, non-refined solves on operators that
        expose ``matmat_with_gram`` (the banded/quantized BSR
        operators, which compose it in two passes). ``"auto"`` (default)
        engages it only when the operator provides a fused SpMM+Gram
        kernel, which none does today, so it behaves as ``"off"``.
        ``"off"`` disables it. The refined/compensated path never uses
        it: an f32 gram accumulation is far above the DS gram's
        precision.
    """

    method: str = "DPR"
    carry_layout: str = "auto"
    fused_gram: str = "auto"
    max_iterations: int = 1000
    tolerance: float = 1e-8
    max_dim_sub: Optional[int] = None
    init_dim: Optional[int] = None
    sticky_convergence: bool = True
    gjd_inner_iters: Optional[int] = None
    gjd_inner_tol: float = 1e-12
    gjd_inner_schedule: str = "adaptive"
    gjd_preconditioner: str = "none"
    gjd_warm_start: bool = False
    n_reorth: int = 2
    relative_tolerance: bool = False
    orthonormalization: str = "cholqr2"
    expansion: str = "doubling"
    dtype: str = "float64"
    refined: bool = False
    locking: bool = False
    matmul_precision: Optional[str] = None
    cheb_degree: Union[int, str] = 0
    final_polish: int = 0
    polish_update: str = "dpr"

    def __post_init__(self):
        validate_method(self.method)
        require(self.max_iterations >= 1, InvalidOptionsError,
                "max_iterations must be >= 1")
        require(self.tolerance > 0, InvalidOptionsError, "tolerance must be > 0")
        require(self.orthonormalization in ("cholqr2", "qr"),
                InvalidOptionsError,
                f"unknown orthonormalization {self.orthonormalization!r}")
        require(self.gjd_preconditioner in ("none", "dpr", "olsen"),
                InvalidOptionsError,
                f"unknown gjd_preconditioner {self.gjd_preconditioner!r}")
        require(self.gjd_inner_schedule in ("adaptive", "fixed"),
                InvalidOptionsError,
                f"unknown gjd_inner_schedule {self.gjd_inner_schedule!r}")
        require(self.expansion in ("doubling", "lowest-k"),
                InvalidOptionsError,
                f"unknown expansion {self.expansion!r}")
        require(self.matmul_precision in (None, "bfloat16", "bfloat16_3x",
                                          "tensorfloat32", "float32",
                                          "highest"),
                InvalidOptionsError,
                f"unknown matmul_precision {self.matmul_precision!r}")
        require(self.cheb_degree == "auto"
                or (isinstance(self.cheb_degree, (int, np.integer))
                    and self.cheb_degree >= 0),
                InvalidOptionsError,
                "cheb_degree must be a non-negative int or 'auto'")
        require(self.fused_gram in ("auto", "on", "off"),
                InvalidOptionsError,
                f"unknown fused_gram {self.fused_gram!r} "
                "(supported: 'auto', 'on', 'off')")
        require(self.carry_layout in ("auto", "flat", "chunked"),
                InvalidOptionsError,
                f"unknown carry_layout {self.carry_layout!r}")
        require(self.carry_layout != "chunked" or self.refined,
                InvalidOptionsError,
                "carry_layout='chunked' requires refined=True (the "
                "chunked form is bit-identical only through the "
                "compensated-Gram pipeline)")
        require(self.carry_layout != "chunked"
                or self.orthonormalization == "cholqr2",
                InvalidOptionsError,
                "carry_layout='chunked' requires "
                "orthonormalization='cholqr2': the Householder-QR "
                "cleanup sweep projects with a plain (non-compensated) "
                "Gram, which has no bit-identical chunked form")
        require(self.final_polish >= 0, InvalidOptionsError,
                "final_polish must be >= 0")
        require(self.final_polish == 0 or self.refined, InvalidOptionsError,
                "final_polish requires refined=True (the polish runs on "
                "the refined path's off-diagonal operator splits)")
        require(self.polish_update in ("dpr", "olsen"),
                InvalidOptionsError,
                f"unknown polish_update {self.polish_update!r}")
        jnp.dtype(self.dtype)  # raises on nonsense


@dataclasses.dataclass(frozen=True)
class ResolvedConfig:
    """Options resolved against a concrete problem (static under jit)."""

    lowest: int
    method: str
    max_iterations: int
    tolerance: float
    max_dim: int
    init_dim: int
    m_max: int
    sticky: bool
    gjd_inner_iters: int
    gjd_inner_tol: float
    gjd_schedule: str
    gjd_precond: str
    gjd_warm: bool
    n_reorth: int
    relative: bool
    ortho: str
    expansion: str
    dtype: str
    generalized: bool
    refined: bool = False
    locking: bool = False
    # None = leave the platform default (f64 solves are never demoted);
    # f32 solves resolve to "float32" unless the user overrode it.
    matmul_precision: Optional[str] = None
    cheb_degree: int = 0
    cheb_auto: bool = False
    final_polish: int = 0
    polish_update: str = "dpr"
    carry_layout: str = "flat"
    # Incremental-H engine consuming the operator's fused SpMM+Gram for
    # the expand block (set by the solver entry point — requires an
    # operator exposing ``matmat_with_gram``; see solver.eigensolve).
    fused_gram: bool = False


def merge_options(options: Optional[DavidsonOptions],
                  overrides: dict) -> DavidsonOptions:
    """Options + keyword overrides -> validated DavidsonOptions."""
    opts = options or DavidsonOptions()
    if overrides:
        opts = DavidsonOptions(**{**dataclasses.asdict(opts), **overrides})
    return opts


def subspace_cap(init_dim: int, max_dim: int, step: Optional[int] = None) -> int:
    """Largest subspace dimension the expansion schedule can reach.

    Doubling (``step=None``): the basis doubles each expansion (the
    correction block has as many columns as the basis,
    ``src/davidson.f90:199``) and expansion happens whenever the
    *current* dimension is <= max_dim (``src/davidson.f90:195``), so
    dimensions follow ``init, 2*init, 4*init, ...`` until the first value
    exceeding max_dim, then collapse to ``init``. The padded width is
    that first exceeding value (or init if init already exceeds max_dim).

    Lowest-k (``step=k``): the basis grows by at most ``step`` columns
    per expansion, but partial admissions (SVQB drops, the noise gate,
    locking, rank-deficient warm starts) mean the CURRENT dimension can
    be any value <= max_dim when an expansion fires — so the padded
    width must be ``max_dim + step`` exactly, not the first lattice
    value past max_dim. A smaller cap makes the expansion's
    dynamic-update-slice clamp its start column and silently overwrite
    live basis columns (measured: a locking+warm-start solve with a
    non-aligned ``max_dim`` froze at 5.8e-4 while overwriting its own
    corrections every cycle).
    """
    cap = init_dim
    while cap <= max_dim:
        cap = cap * 2 if step is None else cap + step
    if step is not None and init_dim <= max_dim:
        cap = max(cap, max_dim + step)
    return cap


# Budget where the device reports no memory limit (the CPU backend).
_FIXED_CARRY_BUDGET = 12e9

# Widest float32 basis measured to converge on the 10M-row north star
# (NVIDIA H100, lowest-20): n_local * m_max = 10,000,384 rows * 64
# columns. At the same n, m_max 156 did not: 30 plain-f32 iterations
# left residuals at 0.007-0.68 and the refined stage stalled on wrong
# eigenvalues (PERF.md). f32 rounding in the projected matrix grows with
# the row count (||A|| ~ n for these operators) and with the basis
# width, so the DEFAULT f32 width is held to this many basis entries.
# One point each side of the limit; the rule is open (PERF.md).
_F32_MAX_BASIS_ENTRIES = 10_000_384 * 64


def _device_bytes_limit():
    """Memory limit of the first device, or None where the backend
    reports none (CPU)."""
    import jax
    stats = jax.devices()[0].memory_stats()
    return None if not stats else stats.get("bytes_limit")


def device_budget_bytes(operator_bytes: int = 0) -> int:
    """Per-device memory budget for the solver's tall working set.

    ``FDT_CARRY_BUDGET_BYTES`` overrides. Otherwise half of what the
    device's memory limit leaves after the operator's own bytes — the
    other half is headroom for XLA scratch, the refined path's extra
    channels and transients the footprint model does not count. A device
    that reports no limit (CPU) gets a fixed 12 GB.
    """
    import os
    env = os.environ.get("FDT_CARRY_BUDGET_BYTES")
    if env is not None:
        return int(float(env))
    limit = _device_bytes_limit()
    if limit is None:
        return int(_FIXED_CARRY_BUDGET)
    return max(int(limit) - int(operator_bytes), 0) // 2


def operator_nbytes(*operators) -> int:
    """Device bytes held by the operators' array leaves."""
    import jax
    return sum(int(getattr(leaf, "nbytes", 0))
               for op in operators if op is not None
               for leaf in jax.tree_util.tree_leaves(op))


def _memory_clamped_max_dim(max_dim: int, *, n_local: int, lowest: int,
                            init_dim: int, step: Optional[int],
                            itemsize: int, generalized: bool,
                            budget: Optional[int] = None) -> int:
    """Clamp the DEFAULT ``max_dim`` so the tall carries fit the
    per-device budget (``budget``; default :func:`device_budget_bytes`).

    Footprint model (deliberately conservative): the engine carries
    ``V`` and ``AV`` (plus ``BV`` when generalized) at the padded width
    ``m_max``; a basis collapse transiently doubles them (old + new
    panel live across the ``dynamic_update_slice``); and roughly
    ``8 * lowest`` further n-length columns exist at any time (Ritz
    block, residuals, corrections, polish scratch)::

        bytes(max_dim) ~ itemsize * n_local
                         * (2 * n_carries * m_max + 8 * lowest)

    The clamp descends the 4-wide lattice from the 10*k default until
    the model fits the budget, flooring at ``init_dim + 4`` so the
    expansion schedule can still fire (a ``max_dim == init_dim`` basis
    collapses every other iteration).
    """
    n_carries = 3 if generalized else 2
    aux = 8 * lowest
    if budget is None:
        budget = device_budget_bytes()
    return _narrowed_max_dim(
        max_dim, init_dim, step,
        lambda m_max: (itemsize * n_local * (2 * n_carries * m_max + aux)
                       <= budget))


def _narrowed_max_dim(max_dim: int, init_dim: int, step: Optional[int],
                      fits) -> int:
    """The widest ``max_dim`` on the 4-wide lattice at or below
    ``max_dim`` whose padded width ``m_max`` satisfies ``fits(m_max)``,
    flooring at ``init_dim + 4``."""
    def ok(md: int) -> bool:
        return fits(subspace_cap(init_dim, md, step))

    floor = init_dim + 4
    if max_dim <= floor or ok(max_dim):
        return max_dim
    md = max_dim - (max_dim % 4 or 4)
    while md > floor and not ok(md):
        md -= 4
    return max(md, floor)


def validate_initial_vectors(initial_vectors, n: int, init_dim: int,
                             dtype):
    """Validated (n, j) warm-start block as an array of ``dtype``.

    Shared by every entry point accepting ``initial_vectors``
    (solver.eigensolve, parallel.eigensolve_sharded,
    checkpoint.eigensolve_checkpointed). Returns None for None.
    """
    from fortran_davidson_tpu.utils.errors import OperatorError
    if initial_vectors is None:
        return None
    X0 = jnp.asarray(initial_vectors, dtype)
    require(X0.ndim == 2 and X0.shape[0] == n, OperatorError,
            f"initial_vectors must be (n, j) with n={n}; got "
            f"{X0.shape}")
    require(1 <= X0.shape[1] <= init_dim, OperatorError,
            f"initial_vectors: j={X0.shape[1]} must be in "
            f"[1, init_dim={init_dim}]")
    return X0


def _resolve_carry_layout(opts: DavidsonOptions, n: int, sharded: bool,
                          shard_row_divisor: int = 1) -> str:
    """Resolve ``carry_layout="auto"`` against the concrete problem.

    Chunked is chosen whenever its requirements hold: the refined
    compensated-Gram pipeline with CholeskyQR2, and a row count whose
    largest power-of-two chunk divisor is big enough that the batched
    Gram einsum stays matmul-shaped (a prime-ish n would degrade the
    chunk toward 1 row and serialize the reduction). The GSPMD engine
    qualifies too — chunks are sized to divide the per-shard row count
    (``utils.ds._chunk_sharded``), so the (n/c, c, m) carries row-shard
    on chunk boundaries.
    """
    if opts.carry_layout != "auto":
        return str(opts.carry_layout)
    from fortran_davidson_tpu.utils.ds import _chunk_sharded
    if (opts.refined and opts.orthonormalization == "cholqr2"
            and _chunk_sharded(n, shard_row_divisor if sharded else 1)
            >= 256):
        return "chunked"
    return "flat"


def resolve_options(opts: DavidsonOptions, lowest: int, n: int,
                    generalized: bool, sharded: bool = False,
                    shard_row_divisor: int = 1,
                    operator_bytes: int = 0) -> ResolvedConfig:
    """Options resolved against a concrete problem. ``operator_bytes``:
    the operators' bytes on each device, subtracted from the memory
    budget of the default-width clamp."""
    require(1 <= lowest, InvalidOptionsError, "lowest must be >= 1")
    cheb_auto = opts.cheb_degree == "auto"
    cheb_on = cheb_auto or opts.cheb_degree >= 2
    require(not (cheb_on and generalized),
            InvalidOptionsError,
            "Chebyshev-filtered restarts (cheb_degree >= 2 or 'auto') "
            "require a standard problem: the filter is a polynomial in "
            "A alone")
    require(lowest <= n, InvalidOptionsError,
            f"lowest={lowest} exceeds matrix dimension {n}")
    init_dim = opts.init_dim if opts.init_dim is not None else 2 * lowest
    require(init_dim >= lowest, InvalidOptionsError,
            "init_dim must be >= lowest")
    require(init_dim <= n, InvalidOptionsError,
            f"init_dim={init_dim} exceeds matrix dimension {n}")
    step = None if opts.expansion == "doubling" else lowest
    if opts.max_dim_sub is not None:
        max_dim = opts.max_dim_sub
    else:
        # Reference default 10*lowest (``src/davidson.f90:115-119``),
        # clamped so the padded expansion schedule fits small problems.
        max_dim = 10 * lowest
        while max_dim > init_dim and subspace_cap(init_dim, max_dim,
                                                  step) > n:
            max_dim //= 2
        # ... and so the tall carries fit the per-device memory budget
        # at large n (see the max_dim_sub attribute docs; the small-n
        # parity schedules above are never touched: the clamp only fires
        # when the footprint model exceeds the budget).
        n_local = n // max(shard_row_divisor if sharded else 1, 1)
        itemsize = jnp.dtype(opts.dtype).itemsize
        max_dim = _memory_clamped_max_dim(
            max_dim, n_local=n_local, lowest=lowest, init_dim=init_dim,
            step=step, itemsize=itemsize, generalized=generalized,
            budget=device_budget_bytes(operator_bytes))
        if itemsize < 8:
            # ... and, in float32, to the widest basis measured to
            # converge (see _F32_MAX_BASIS_ENTRIES).
            max_dim = _narrowed_max_dim(
                max_dim, init_dim, step,
                lambda m_max: n_local * m_max <= _F32_MAX_BASIS_ENTRIES)
    m_max = subspace_cap(init_dim, max_dim, step)
    require(m_max <= n, InvalidOptionsError,
            f"padded subspace width {m_max} exceeds matrix dimension {n}; "
            "reduce max_dim_sub or init_dim")
    inner = opts.gjd_inner_iters
    if inner is None:
        inner = min(n, 128)
    return ResolvedConfig(
        lowest=lowest,
        method=validate_method(opts.method),
        max_iterations=opts.max_iterations,
        tolerance=float(opts.tolerance),
        max_dim=max_dim,
        init_dim=init_dim,
        m_max=m_max,
        sticky=opts.sticky_convergence,
        gjd_inner_iters=int(inner),
        gjd_inner_tol=float(opts.gjd_inner_tol),
        gjd_schedule=str(opts.gjd_inner_schedule),
        gjd_precond=str(opts.gjd_preconditioner),
        gjd_warm=bool(opts.gjd_warm_start),
        n_reorth=int(opts.n_reorth),
        relative=bool(opts.relative_tolerance),
        ortho=str(opts.orthonormalization),
        expansion=str(opts.expansion),
        dtype=str(jnp.dtype(opts.dtype)),
        generalized=generalized,
        refined=bool(opts.refined),
        locking=bool(opts.locking),
        matmul_precision=(opts.matmul_precision if opts.matmul_precision
                          is not None else
                          ("float32"
                           if jnp.dtype(opts.dtype) == jnp.float32
                           else None)),
        cheb_degree=0 if cheb_auto else int(opts.cheb_degree),
        cheb_auto=cheb_auto,
        final_polish=int(opts.final_polish),
        polish_update=opts.polish_update,
        carry_layout=_resolve_carry_layout(opts, n, sharded,
                                           shard_row_divisor),
    )


@dataclasses.dataclass
class DavidsonResult:
    """Solver output.

    ``iterations`` follows the reference convention: the 1-based index of
    the iteration at which convergence was detected (``src/davidson.f90:
    189-192``); equals ``max_iterations`` with ``converged=False`` when the
    loop ran out (the reference prints a warning and returns
    ``max_iterations + 1``, ``src/davidson.f90:232-235``).
    """

    eigenvalues: jnp.ndarray          # (k,)
    eigenvectors: jnp.ndarray         # (n, k)
    iterations: jnp.ndarray           # scalar int
    converged: jnp.ndarray            # scalar bool
    converged_pairs: jnp.ndarray      # (k,) bool
    residual_norms: jnp.ndarray       # (k,)
    residual_history: jnp.ndarray     # (max_iterations, k); NaN after exit
    subspace_dims: jnp.ndarray        # (max_iterations,); 0 after exit
    operator_columns: jnp.ndarray = None  # scalar int: live columns A was
    #   applied to across the solve (the work metric locking reduces)
    stalled: jnp.ndarray = None       # scalar bool: the refined loop hit
    #   its attainable floor (zero admitted correction columns, or no
    #   residual improvement for core.loop._PLATEAU_ITERS iterations)
    inner_iterations: jnp.ndarray = None  # scalar int (GJD only):
    #   cumulative inner-MINRES iterations across the solve — the cost
    #   the adaptive gjd_inner_schedule reduces; None for DPR/OLSEN
    #   and exited early; with ``final_polish`` the polish may still
    #   report converged=True against TRUE residuals. Distinguishes
    #   "floor reached" from plain running-out-of-iterations.
    eigenvalues_lo: jnp.ndarray = None  # (k,) low words of the polished
    #   eigenvalues (final_polish only): ``eigenvalues`` is f32, whose
    #   representation rounding (~6e-8·λ) exceeds a 1e-8 tolerance;
    #   ``float64(eigenvalues) + float64(eigenvalues_lo)`` on the host
    #   recovers the full-precision values the residual check used.

    def block_until_ready(self):
        self.eigenvalues.block_until_ready()
        return self


def result_flatten(res: DavidsonResult):
    return (res.eigenvalues, res.eigenvectors, res.iterations, res.converged,
            res.converged_pairs, res.residual_norms, res.residual_history,
            res.subspace_dims, res.operator_columns, res.stalled,
            res.inner_iterations, res.eigenvalues_lo), None


def result_unflatten(aux, children):
    return DavidsonResult(*children)


import jax  # noqa: E402  (registration after class definitions)

jax.tree_util.register_pytree_node(DavidsonResult, result_flatten,
                                   result_unflatten)

"""The block-Davidson outer loop as a jitted `lax.while_loop`.

Fixed-shape redesign of the reference's allocating Fortran loop
(``src/davidson.f90:138-229`` dense, ``:375-441`` matrix-free):

- **Fixed shapes.** The basis lives in a padded buffer ``V in R^{n x m_max}``
  whose active columns are a prefix tracked by an integer ``m``; padded
  columns are identically zero. ``m_max`` is the largest dimension the
  doubling schedule can reach (see ``config.subspace_cap``), so
  grow/collapse are pure data movement — XLA compiles one program.
- **Cached operator applications.** The reference re-applies the operator
  to the whole basis every iteration (``src/davidson.f90:378-379``) or
  recomputes the projection with full-matrix GEMMs (``:223-227``). Here
  A@V and B@V are cached; each expansion applies the operator only to the
  *new* orthonormal block, and collapse updates the caches with a
  triangular solve — zero extra operator applications.
- **Span parity.** Every transformation preserves the exact-arithmetic
  subspace span of the reference schedule (expansion by the correction
  block; collapse to the first ``init_dim`` Ritz vectors,
  ``src/davidson.f90:218``), so Ritz values — and iteration counts — match
  the reference within roundoff.
"""

from __future__ import annotations

import contextlib
import os
import weakref
from typing import Optional

import jax
import jax.numpy as jnp

from fortran_davidson_tpu.config import DavidsonResult, ResolvedConfig
from fortran_davidson_tpu.core import chebyshev
from fortran_davidson_tpu.core import correction as corr_mod
from fortran_davidson_tpu.core import orthogonal, subspace
from fortran_davidson_tpu.ops.operators import LinearOperator


# Precise-path plateau exit: consecutive iterations without >= 1%
# improvement of the worst unconverged wanted residual before the loop
# concludes it has hit the f32-basis floor (see init_state).
_PLATEAU_ITERS = 10

# Trial-polish poll point: when the fine no-progress counter first
# reaches this value, the loop asks the POLISH whether the current k
# pairs already certify at the user's tolerance (see run_state). Far
# below _PLATEAU_ITERS so a certifiable basis exits ~6 iterations
# sooner than the noise-window heuristics alone.
_POLISH_POLL_AT = 4


def _precision_ctx(cfg: ResolvedConfig):
    """Matmul-precision context for everything traced inside the solver.

    A platform default that demotes f32 matmul operands (TF32 on GPU
    tensor cores, 10-bit mantissa) injects operand noise into the projected
    matrix, Ritz products, residuals, and the GJD inner Krylov (measured:
    GJD+Olsen at 1M rows f32 diverges under the platform default,
    converges at f32 precision). The tall-skinny matmuls that dominate
    are memory-bound, so full-precision products cost little. A no-op on
    f64 — parity pins are unaffected. See
    ``DavidsonOptions.matmul_precision``.
    """
    if cfg.matmul_precision is None:
        return contextlib.nullcontext()
    return jax.default_matmul_precision(cfg.matmul_precision)


def init_state(cfg: ResolvedConfig, A: LinearOperator,
               B: Optional[LinearOperator], constrain=None,
               X0=None) -> dict:
    """Initial loop state (a checkpointable pytree of arrays).

    ``chunk_end`` bounds how far a single ``run_state`` call iterates —
    ``max_iterations`` for a one-shot solve, smaller for the chunked
    driver that interleaves checkpointing/callbacks (see
    :func:`run_chunked`).

    ``X0``: optional (n, j) warm-start vectors, j <= init_dim — see
    ``subspace.initial_subspace_with_guess``.
    """
    n = A.shape[0]
    k = cfg.lowest
    m_max = cfg.m_max
    init_dim = cfg.init_dim
    dt = jnp.dtype(cfg.dtype)
    gen = B is not None

    if cfg.fused_gram and (gen or cfg.refined
                           or cfg.expansion != "lowest-k"):
        raise ValueError(
            "fused_gram requires a standard, non-refined, lowest-k "
            "configuration (the solver entry point gates this)")

    diag_a = A.diagonal().astype(dt)

    if X0 is None:
        V0 = subspace.initial_subspace(diag_a, init_dim, m_max)
        ok0 = (jnp.arange(m_max) < init_dim).astype(dt)
        m0 = jnp.asarray(init_dim, jnp.int32)
    else:
        with _precision_ctx(cfg):
            V0, ok0, m0 = subspace.initial_subspace_with_guess(
                diag_a, X0, init_dim, m_max, precise=cfg.refined)
        if cfg.expansion == "doubling":
            # Doubling's dimension bookkeeping doubles m REGARDLESS of
            # the live count (reference parity, ``src/davidson.f90:199``)
            # and its roll-add placement requires m on the init_dim
            # lattice: an off-lattice m from a rank-deficient guess
            # would overrun m_max and WRAP correction columns circularly
            # into live basis columns (measured: subspace_dims hit 80
            # with m_max=64 and col_ok entries reached 2.0). Snap m to
            # init_dim — dropped guess columns stay as zero columns
            # inside the active window, the SVQB-hole pattern the
            # loop's masks already handle.
            m0 = jnp.asarray(init_dim, jnp.int32)
    with _precision_ctx(cfg):
        AV0 = A.matmat(V0)
        BV0 = B.matmat(V0) if gen else None
        spec_ub = (chebyshev.lanczos_upper_bound(A.matmat, n, dt)
                   if (cfg.cheb_degree >= 2 or cfg.cheb_auto) else None)
        # Fused-gram H seed: MUST stay inside the precision context —
        # a demoted-operand platform default would poison the
        # carried projected matrix until the first collapse re-seed.
        H0 = subspace.project(V0, AV0) if cfg.fused_gram else None
    if cfg.carry_layout == "chunked":
        # Store the tall carries pre-chunked as (n/c, c, m_max) — the
        # layout the compensated Gram consumes — so the per-iteration
        # relayout copies never exist (see DavidsonOptions.carry_layout).
        # c matches gram_ds's default chunk for bit-identical reductions
        # (single device); under GSPMD row sharding c additionally
        # divides the per-shard row count so chunks never straddle
        # shards (see utils.ds._chunk_sharded).
        from fortran_davidson_tpu.utils.ds import _chunk_sharded
        c = _chunk_sharded(n, getattr(constrain, "row_divisor", 1) or 1)
        V0 = V0.reshape(n // c, c, m_max)
        AV0 = AV0.reshape(n // c, c, m_max)
        BV0 = None if BV0 is None else BV0.reshape(n // c, c, m_max)
    state = dict(
        V=V0,
        AV=AV0,
        m=m0,
        col_ok=ok0,
        it=jnp.asarray(0, jnp.int32),
        chunk_end=jnp.asarray(cfg.max_iterations, jnp.int32),
        has_conv=jnp.zeros((k,), bool),
        all_conv=jnp.asarray(False),
        evals=jnp.zeros((k,), dt),
        evecs=jnp.zeros((n, k), dt),
        errors=jnp.full((k,), jnp.inf, dt),
        history=jnp.full((cfg.max_iterations, k), jnp.nan, dt),
        dims=jnp.zeros((cfg.max_iterations,), jnp.int32),
        op_cols=m0,
        stalled=jnp.asarray(False),
    )
    if gen:
        state["BV"] = BV0
    if cfg.fused_gram:
        # Incremental projected matrix (see DavidsonOptions.fused_gram):
        # seeded with one full Gram (H0, computed under the precision
        # context above); thereafter each expansion's new columns arrive
        # from the operator's fused SpMM+Gram and a collapse re-seeds
        # from the thin restart basis.
        state["H"] = H0
    if cfg.method == "GJD":
        # Cumulative inner-MINRES iterations across the solve — the
        # cost metric the adaptive gjd_inner_schedule reduces (the
        # reference has no analogue: its DSYSV factorizes exactly,
        # ``src/davidson.f90:719-732``).
        state["inner_ops"] = jnp.asarray(0, jnp.int32)
        if cfg.gjd_warm:
            # Previous raw correction block, recycled as the next inner
            # solve's initial guess (gjd_warm_start). Zero = cold start.
            kk0 = k if cfg.expansion == "lowest-k" else m_max
            state["corr_prev"] = jnp.zeros((n, kk0), dt)
    if cfg.refined:
        # Residual-plateau tracking (precise path only): at scale the
        # f32-stored basis floors the attainable in-loop residual
        # (~3.5e-5 absolute at 10M rows) far above 1e-8-grade
        # tolerances; once the worst wanted residual stops improving,
        # the loop is grinding noise. Track the best worst-pair
        # residual and exit after _PLATEAU_ITERS non-improving
        # iterations (``final_polish`` then closes the gap and
        # re-checks convergence against TRUE residuals). A safety net
        # behind the expand step's zero-admitted-columns stall exit,
        # whose trigger depends on noise-gate specifics.
        state["best_err"] = jnp.asarray(jnp.inf, dt)
        state["no_prog"] = jnp.asarray(0, jnp.int32)
    if spec_ub is not None:
        state["spec_ub"] = spec_ub
    if constrain is not None:
        state = constrain(state)
    return state


def run_state(cfg: ResolvedConfig, A: LinearOperator,
              B: Optional[LinearOperator], state: dict,
              constrain=None, A_off: Optional[LinearOperator] = None,
              B_off: Optional[LinearOperator] = None) -> dict:
    """Iterate the Davidson while_loop until convergence, ``chunk_end``,
    or ``max_iterations``.

    ``A_off``/``B_off``: off-diagonal splits for the refined-precision
    path (required when ``cfg.refined``; see ``core.refine``).
    """
    n = A.shape[0]
    k = cfg.lowest
    m_max = cfg.m_max
    init_dim = cfg.init_dim
    dt = jnp.dtype(cfg.dtype)
    gen = B is not None
    precise = cfg.refined
    if precise and A_off is None:
        raise ValueError("cfg.refined requires A_off (= A.offdiag())")

    diag_a = A.diagonal().astype(dt)
    diag_b = B.diagonal().astype(dt) if gen else jnp.ones((n,), dt)

    if cfg.fused_gram and (gen or precise or cfg.expansion != "lowest-k"):
        raise ValueError(
            "fused_gram requires a standard, non-refined, lowest-k "
            "configuration (the solver entry point gates this)")

    chunked = cfg.carry_layout == "chunked"
    if chunked:
        # Round 5: the GSPMD engine runs chunked too — chunks are sized
        # to divide the per-shard row count (whole chunks per device),
        # so the (n/c, c, m) leading axis row-shards cleanly and the
        # compensated Gram consumes local chunks + the same psum'd
        # two_sum tree as the flat layout.
        from fortran_davidson_tpu.utils.ds import _chunk_sharded
        c_carry = _chunk_sharded(n, getattr(constrain, "row_divisor", 1)
                                 or 1)

    def t_chunk(X):
        """Flat (n, b) -> carry layout (free on the flat layout)."""
        if not chunked:
            return X
        return X.reshape(n // c_carry, c_carry, X.shape[-1])

    def t_dot(Tc, Wsm):
        """Carry @ (m, b) -> FLAT (n, b); contraction order matches
        ``jnp.dot`` per element, so results are bit-identical."""
        if not chunked:
            return jnp.dot(Tc, Wsm, preferred_element_type=dt)
        out = jnp.einsum("rcm,mk->rck", Tc, Wsm,
                         preferred_element_type=dt)
        return out.reshape(n, Wsm.shape[-1])

    def gram_carry(Xc, Yc):
        """Compensated Gram on carries (bit-identical either layout)."""
        from fortran_davidson_tpu.utils.ds import gram_ds, gram_ds_pre
        return gram_ds_pre(Xc, Yc) if chunked else gram_ds(Xc, Yc)

    def t_write(Tc, block, col):
        """Write a flat (n, b) block into the carry at column ``col``
        (dynamic_update_slice aliases the while-carry in place)."""
        z0 = jnp.zeros((), jnp.int32)
        col = jnp.asarray(col, jnp.int32)
        if chunked:
            return jax.lax.dynamic_update_slice(Tc, t_chunk(block),
                                                (z0, z0, col))
        return jax.lax.dynamic_update_slice(Tc, block, (z0, col))

    def cond(st):
        # `stalled`: a lowest-k expansion admitted ZERO new columns below
        # the subspace cap — the state is then an exact fixed point of
        # the body (nothing changed, nothing ever will), so spinning to
        # max_iterations would only burn time. Exit with converged as-is
        # (the caller sees honest residuals; `final_polish` can still
        # close the remaining gap).
        return ((st["it"] < jnp.minimum(st["chunk_end"],
                                        cfg.max_iterations))
                & ~st["all_conv"] & ~st["stalled"])

    def body(st):
        V, AV = st["V"], st["AV"]
        BV = st["BV"] if gen else None
        m = st["m"]
        # Active columns = prefix up to m MINUS columns dropped by the
        # rank-revealing orthonormalization; the flags are carried in the
        # state (maintained by expand/collapse below) so no pass over V
        # is needed to re-derive them.
        mask = orthogonal.col_mask(m, m_max, dt) * st["col_ok"]
        # Ritz pairs live in *pair* index space: masked_eigh sorts active
        # eigenpairs to a prefix of width sum(mask), regardless of where
        # the surviving basis COLUMNS sit (SVQB drops can leave interior
        # holes in `mask`). Pair-indexed products must therefore use a
        # prefix mask, not the scattered basis-column mask.
        pair_mask = orthogonal.col_mask(
            jnp.sum(mask).astype(jnp.int32), m_max, dt)

        # Rayleigh-Ritz on the active block (masked padded eigh).
        if precise and not gen:
            # DS-measured projected matrix + beyond-f32-eigh Ritz
            # refinement for the k wanted pairs: the f32 eigh floors the
            # attainable residual at ~eps*||H|| (measured ~4e-6 at
            # ||H||~60); first-order perturbation against the DS
            # projected residual — of the SAME penalized matrix the eigh
            # diagonalized — removes that floor at O(m²k) cost.
            from fortran_davidson_tpu.core import refine as _refine
            from fortran_davidson_tpu.utils.ds import DS, two_sum
            H_ds = gram_carry(V, AV)
            H = H_ds.hi + H_ds.lo
            pen = jnp.diag(subspace._pad_penalties(H, mask))
            w, W = jnp.linalg.eigh(H + pen)
            ph, pl = two_sum(H_ds.hi, pen)
            W = W.at[:, :k].set(_refine.refine_ritz(
                DS(ph, pl + H_ds.lo), w, W, k))
        elif precise:
            # Generalized refined path: the pencil is first-class (the
            # reference's free engine is always generalized,
            # ``src/davidson.f90:277-279``). Both projections are
            # DS-measured, the masked DSYGV-style reduction runs on
            # their f32 roundings, and the k wanted eigenvectors are
            # refined first-order against the DS pencil residual
            # H y - θ S y — the same mechanism that removes the
            # ~eps*||H|| f32-eigh floor on the standard path.
            from fortran_davidson_tpu.core import refine as _refine
            from fortran_davidson_tpu.utils.ds import DS, two_sum
            H_ds = gram_carry(V, AV)
            S_ds = gram_carry(V, BV)
            H = H_ds.hi + H_ds.lo
            S = S_ds.hi + S_ds.lo
            w, W = subspace.masked_generalized_eigh(H, S, mask)
            # The SAME penalized matrices the reduction diagonalized,
            # held as DS pairs (penalties added with exact two_sum).
            pen = jnp.diag(subspace._pad_penalties(H, mask))
            spen = jnp.diag(1.0 - mask)
            ph, pl = two_sum(H_ds.hi, pen)
            sh, sl = two_sum(S_ds.hi, spen)
            W = W.at[:, :k].set(_refine.refine_ritz_pencil(
                DS(ph, pl + H_ds.lo), DS(sh, sl + S_ds.lo), w, W, k))
        else:
            # Fused-gram engine: H is carried in the state (seeded at
            # init, extended by the fused kernel at each expansion) —
            # the per-iteration VᵀAV recomputation (two tall reads)
            # disappears. Identical in exact arithmetic: CGS2 never
            # touches admitted basis columns, so old H entries stay
            # valid; inactive columns are zero in both V and H.
            H = (st["H"] if cfg.fused_gram
                 else subspace.project(V, AV, precise=precise))
            S = subspace.project(V, BV, precise=precise) if gen else None
            w, W = subspace.ritz_decomposition(H, S, mask)

        # Ritz vectors and block residuals R = (AV)W - (BV)W diag(w),
        # computed from the caches (the reference free path does the same,
        # ``src/davidson.f90:401-410``; the dense path's per-column DGEMVs
        # at ``:163-170`` are equivalent in exact arithmetic).
        #
        # Width: with the lowest-k expansion only the k wanted pairs ever
        # feed corrections, convergence checks, or outputs — computing
        # the Ritz products on k columns instead of m_max turns three
        # full (n, m_max) memory streams into (n, k) ones (at the
        # 10M-row north-star shape that is ~95% of their traffic). The
        # doubling schedule corrects every active pair (reference
        # semantics) and keeps the full width.
        kk = k if cfg.expansion == "lowest-k" else m_max
        Wk = W[:, :kk]
        pmk = pair_mask[:kk]
        X = t_dot(V, Wk) * pmk[None, :]
        AXW = t_dot(AV, Wk)
        BXW = t_dot(BV, Wk) if gen else X
        R = (AXW - BXW * w[:kk][None, :]) * pmk[None, :]

        if precise:
            # Refined path: TRUE residuals + Rayleigh-refined eigenvalues
            # for the k wanted pairs. The compensated residual ALSO
            # replaces the cache-based one in the correction pipeline:
            # the cache R carries ~sqrt(n)*eps*λ accumulation noise,
            # which at scale exceeds the true residual long before the
            # tolerance is met — corrections computed from it are noise,
            # get annihilated by CGS2, and the iteration stalls
            # (measured: stuck at ~4e-6 at n=65k while the true residual
            # target needs 2e-6). The refined R carries signal down to
            # ~eps² and keeps the subspace improving to the f32-storage
            # limit.
            from fortran_davidson_tpu.core import refine
            ref = refine.refined_pairs(
                A_off, diag_a, X[:, :k],
                B_off=B_off, diag_b=diag_b if gen else None)
            # Nonexistent pairs (pair_mask == 0) are masked with `where`,
            # not multiplication: refined values for zero columns are
            # guarded inside refined_pairs, but a select is NaN-proof by
            # construction (NaN * 0 == NaN would poison the correction
            # block and then the basis). Their "residual" is unknowable,
            # so errors reads inf — the pair-existence convergence guard
            # below agrees.
            pm_k = pair_mask[:k] > 0.5
            errors = jnp.where(pm_k, ref.errors.astype(dt), jnp.inf)
            w_report = jnp.concatenate([ref.evals.astype(dt), w[k:]])
            R = R.at[:, :k].set(jnp.where(pm_k[None, :],
                                          ref.residual.astype(dt), 0.0))
        else:
            errors = jnp.linalg.norm(R[:, :k], axis=0)
            w_report = w
        if cfg.relative:
            conv_now = errors < cfg.tolerance * jnp.maximum(
                jnp.abs(w_report[:k]), 1.0)
        else:
            conv_now = errors < cfg.tolerance
        # A pair can only converge if it EXISTS: with fewer than k
        # active basis columns (e.g. a rank-deficient warm start), the
        # masked Ritz products are identically zero for the missing
        # pairs — their zero "residuals" must not read as convergence
        # (pre-fix: a tiled single-vector guess returned garbage
        # eigenvalues with converged=True at iteration 1).
        conv_now = conv_now & (pair_mask[:k] > 0.5)
        has_conv = (st["has_conv"] | conv_now) if cfg.sticky else conv_now
        all_conv = jnp.all(has_conv)

        it = st["it"]
        history = st["history"].at[it].set(errors)
        dims = st["dims"].at[it].set(m)

        col_ok = st["col_ok"]

        op_cols = st["op_cols"]

        gjd = cfg.method == "GJD"
        warm = gjd and cfg.gjd_warm
        fused = cfg.fused_gram
        inner_ops = st["inner_ops"] if gjd else None
        corr_prev = st["corr_prev"] if warm else None

        def _tail(out, inner, corr):
            # GJD carries (inner_ops[, corr_prev]) behind the common
            # tuple; every cond branch must produce the same pytree.
            if gjd:
                out = out + (inner,)
            if warm:
                out = out + (corr,)
            return out

        def no_update(_):
            # hoist implies not gen; the hoisted block ran (and is
            # discarded here), so its operator columns are still charged.
            opc0 = op_cols + hoist_applied if hoist else op_cols
            out = ((V, AV, m, col_ok, opc0) if not gen
                   else (V, AV, BV, m, col_ok, opc0))
            if fused:
                out = out + (st["H"],)
            return _tail(out, inner_ops, corr_prev)

        def new_block():
            # The correction block has kk columns (k for lowest-k,
            # m_max for doubling).
            corr_mask = pmk
            if cfg.locking:
                # Deflation: converged pairs keep their Ritz vectors in
                # the basis but stop spending correction columns. Their
                # zeroed columns are dropped by the orthonormalization's
                # norm filter, and the live-column accounting below keeps
                # the basis a clean prefix.
                unconv = jnp.ones((kk,), bool).at[:k].set(~has_conv)
                corr_mask = corr_mask * unconv.astype(dt)
            if cfg.method == "DPR":
                corr = corr_mod.dpr_correction(R, w[:kk], diag_a, diag_b,
                                               corr_mask)
            elif cfg.method == "OLSEN":
                corr = corr_mod.olsen_correction(R, w[:kk], X, diag_a,
                                                 diag_b, corr_mask)
            else:
                precond = cfg.gjd_precond in ("dpr", "olsen")
                if cfg.gjd_schedule == "adaptive":
                    # Outer-target-linked inner forcing (inexact JD): the
                    # inner solve stops at absolute residual eta_a * tol
                    # or relative residual eta_r (whichever is looser,
                    # via the clip below) — a correction accurate to
                    # eta_r = 1% relative perturbs the next outer
                    # residual by O(1%), invisible against both the
                    # convergence test and the reference iteration-parity
                    # pins. Looser schedules were MEASURED to cost outer
                    # iterations: linking eta to the current ||r||
                    # (eta ~ ||r|| or ||r||^2) broke small-problem parity
                    # (one-shot JD corrections need near-exact inner
                    # solves), and eta_r = 0.1..0.5 endgame looseness
                    # cost 10 -> 18 outer iterations on a 400k f32 run.
                    # The absolute leg is passed as a per-column RELATIVE
                    # tolerance (MINRES rhs is the outer residual, so
                    # rtol_j * ||r_j|| = eta_a * tol); far from
                    # convergence the clip floors it at gjd_inner_tol —
                    # effectively exact, with the stall cutoff in
                    # `krylov.minres_block` handling the f32 attainable
                    # floor at scale. (The reference's DSYSV solves every
                    # inner system exactly, ``src/davidson.f90:719-732``.)
                    tol_eff = cfg.tolerance * (
                        jnp.maximum(jnp.abs(w[:kk]), 1.0) if cfg.relative
                        else 1.0)
                    rnorm = jnp.linalg.norm(R, axis=0)
                    inner_tol = jnp.clip(
                        0.01 * tol_eff / jnp.maximum(rnorm, 1e-30),
                        cfg.gjd_inner_tol, 1e-2)
                else:
                    inner_tol = cfg.gjd_inner_tol
                corr, it_in = corr_mod.gjd_correction(
                    A.matmat, B.matmat if gen else None, w[:kk], X, R,
                    corr_mask, cfg.gjd_inner_iters, inner_tol,
                    diag_a=diag_a if precond else None,
                    diag_b=diag_b if (precond and gen) else None,
                    olsen_start=cfg.gjd_precond == "olsen",
                    scale=cfg.gjd_precond == "dpr",
                    return_inner_iters=True,
                    warm_t=corr_prev)
                it_inner = it_in.astype(jnp.int32)
            # The RAW (pre-orthonormalization) correction is what the
            # warm start recycles: orthonormalized columns lose the
            # magnitude/shape information the next inner solve reuses.
            corr_raw = corr if warm else None
            Q, alive_q = orthogonal.orthonormalize_block(
                V, corr, corr_mask, n_reorth=cfg.n_reorth, method=cfg.ortho,
                precise=precise)
            # Fused engine: AQ comes out of the fused SpMM+Gram inside
            # expand (it needs the POST-write basis as the gram operand).
            AQ = None if fused else A.matmat(Q)
            return Q, AQ, alive_q, (it_inner if cfg.method == "GJD"
                                    else jnp.zeros((), jnp.int32)), corr_raw

        # Hoist the new-block computation OUT of the expand cond branch
        # for the refined standard path with cheap (non-Krylov)
        # corrections: the CGS projection's compensated Gram then sits
        # in the same scope as the Rayleigh-Ritz Gram, so XLA CSEs
        # their shared (n, m_max) relayout of V (measured 24 ms per
        # iteration at the 10M north star — reads of tall carries
        # inside a cond branch cannot CSE across the branch boundary
        # and would otherwise relayout V a second time). Collapse
        # iterations (1-in-log) waste the block; identical values
        # either way, so trajectories are bit-unchanged.
        hoist = (precise and not gen
                 and cfg.method in ("DPR", "OLSEN"))
        hoisted = new_block() if hoist else None
        # Operator-column accounting for the hoisted path: A runs on the
        # post-orthonormalization block EVERY iteration (including
        # collapse/converged iterations, where the block is discarded)
        # and on columns the RQ gate later drops — charge what actually
        # ran, not what survived.
        hoist_applied = (jnp.sum(hoisted[2]).astype(jnp.int32)
                         if hoist else None)

        def expand(_):
            if hoist:
                Q, AQ, alive_q, it_inner, corr_raw = hoisted
            else:
                Q, AQ, alive_q, it_inner, corr_raw = new_block()
            # Columns A.matmat actually ran on (pre-RQ-gate): the honest
            # operator_columns charge for every precise path, hoisted or
            # not. Non-precise paths have no gate, so this equals the
            # post-placement live count there.
            applied = jnp.sum(alive_q).astype(jnp.int32)
            if precise:
                # Spectral noise gate (second line of defense behind the
                # SVQB noise-floor threshold): a whitened junk direction
                # has a Rayleigh quotient at the mean-diagonal scale
                # (~n/2 for diag ~ 1..n), while legitimate DPR/GJD
                # corrections for the LOWEST pairs concentrate where
                # |lambda - d_i| is small — measured <= ~120x the wanted
                # eigenvalues. One admitted junk column inflates ||H||
                # until the f32 eigh can no longer resolve the wanted
                # pairs, so dropping a rare borderline-legitimate column
                # is the cheap side of the asymmetry. AQ is already in
                # hand; the gate is one column reduction. Survivors are
                # recompacted to a prefix (the lowest-k placement relies
                # on it).
                rq = jnp.sum(Q * AQ, axis=0)
                wmax = jnp.max(jnp.abs(w[:k]) * pair_mask[:k])
                cap = 250.0 * jnp.maximum(wmax, 1.0)
                # Two-sided: junk Rayleigh quotients sit at the MEAN
                # DIAGONAL scale, which for shifted/negative spectra is
                # negative — a one-sided rq <= cap test would pass them
                # silently. Legitimate corrections are bounded below by
                # the lowest Ritz value (|rq| <= cap by construction).
                keep = alive_q * (jnp.abs(rq) <= cap).astype(dt)
                order = jnp.argsort(jnp.logical_not(keep > 0.5),
                                    stable=True)
                Q = (Q * keep[None, :])[:, order]
                AQ = (AQ * keep[None, :])[:, order]
                alive_q = keep[order]
            live = jnp.sum(alive_q).astype(jnp.int32)
            if cfg.expansion == "lowest-k":
                # Survivors occupy a prefix of the kk-column block; write
                # them at column m in place (dynamic_update_slice aliases
                # the while-carry — only k columns are written, vs a full
                # (n, m_max) read-modify-write of the roll-add; writes
                # are the scarcer memory traffic). The
                # basis stays a hole-free prefix via the live count.
                V2 = t_write(V, Q, m)
                if fused:
                    # The Davidson hot pair: AQ and its projection
                    # against the post-write basis,
                    # G = V2ᵀ(AQ) (the operators compose it in two
                    # passes; a fused kernel would keep AQ on chip).
                    # G's rows/columns ARE the new entries of the
                    # carried projected matrix; columns beyond
                    # the live count are zero (zero Q columns), exactly
                    # matching the recomputed-Gram state.
                    AQ2, G = A.matmat_with_gram(Q, v=V2)
                    AV2 = t_write(AV, AQ2, m)
                    z0 = jnp.asarray(0, jnp.int32)
                    Hf = jax.lax.dynamic_update_slice(
                        st["H"], G.astype(dt), (z0, m))
                    Hf = jax.lax.dynamic_update_slice(
                        Hf, G.T.astype(dt), (m, z0))
                else:
                    AV2 = t_write(AV, AQ, m)
                ok2 = jax.lax.dynamic_update_slice(col_ok, alive_q, (m,))
                m2 = m + live
            else:
                # doubling: new columns shift to [m, 2m); the reference
                # schedule's dimension bookkeeping (iteration-count
                # parity depends on m, not on drops).
                V2 = V + t_chunk(jnp.roll(Q, m, axis=1))
                AV2 = AV + t_chunk(jnp.roll(AQ, m, axis=1))
                ok2 = col_ok + jnp.roll(alive_q, m)
                m2 = 2 * m
            charged = (op_cols + hoist_applied if hoist
                       else op_cols + applied)
            if gen:
                BQ = B.matmat(Q)
                if cfg.expansion == "lowest-k":
                    BV2 = t_write(BV, BQ, m)
                else:
                    BV2 = BV + t_chunk(jnp.roll(BQ, m, axis=1))
                out = (V2, AV2, BV2, m2, ok2, charged)
            else:
                out = (V2, AV2, m2, ok2, charged)
            if fused:
                out = out + (Hf,)
            return _tail(out, inner_ops + it_inner if gjd else None,
                         corr_raw)

        def collapse(_):
            # NOTE: recompute V@W2 / AV@W2 rather than slicing the Ritz
            # products computed above — slicing looks cheaper (saves 2-3
            # tall matmuls) but forces X/AXW/BXW to stay LIVE across the
            # branch, raising peak HBM by up to three (n, m_max) buffers;
            # at the 10M-row north-star scale that alone overflows the
            # chip (measured: 17.3G > 15.75G). Collapse is 1-in-log
            # iterations; headroom wins.
            W2 = W[:, :init_dim]
            X2 = t_dot(V, W2)
            if (cfg.cheb_degree >= 2 or cfg.cheb_auto) and not gen:
                # ChASE-style filtered restart: damp the components of
                # the restart block lying in [first unwanted Ritz value,
                # spectral upper bound]. The filtered block leaves the
                # polynomial span of the cached AV, so its A-image is
                # recomputed fresh (degree + 1 extra block applications
                # per collapse; collapses are 1-in-log iterations).
                a = w[init_dim]
                b = jnp.maximum(st["spec_ub"].astype(dt),
                                a + jnp.asarray(1e-3, dt)
                                * (jnp.abs(a) + 1.0))
                lo = jnp.minimum(w[0], a - jnp.asarray(1e-6, dt)
                                 * (jnp.abs(a) + 1.0))
                degree = (chebyshev.auto_degree(lo, a, b, dt)
                          if cfg.cheb_auto else cfg.cheb_degree)
                X2 = chebyshev.chebyshev_filter(
                    A.matmat, X2, degree, a, b, lo)
                Qc, Rc = orthogonal.thin_qr_collapse(X2, method=cfg.ortho,
                                                     precise=precise)
                AQc = A.matmat(Qc)
            else:
                AX2 = t_dot(AV, W2)
                Qc, Rc = orthogonal.thin_qr_collapse(X2, method=cfg.ortho,
                                                     precise=precise)
                AQc = orthogonal.right_tri_solve(AX2, Rc)
            Vn = t_write(jnp.zeros_like(V), Qc, 0)
            AVn = t_write(jnp.zeros_like(AV), AQc, 0)
            mn = jnp.asarray(init_dim, jnp.int32)
            okn = (jnp.arange(m_max) < init_dim).astype(dt)
            opc = op_cols + hoist_applied if hoist else op_cols
            if (cfg.cheb_degree >= 2 or cfg.cheb_auto) and not gen:
                opc = opc + (degree + 1) * init_dim
            if gen:
                BX2 = t_dot(BV, W2)
                BQc = orthogonal.right_tri_solve(BX2, Rc)
                BVn = t_write(jnp.zeros_like(BV), BQc, 0)
                out = (Vn, AVn, BVn, mn, okn, opc)
            else:
                out = (Vn, AVn, mn, okn, opc)
            if fused:
                # Re-seed the carried projection from the thin restart
                # basis (collapses are 1-in-log iterations; one full
                # Gram here costs what the recomputed engine pays every
                # iteration).
                out = out + (jnp.dot(Vn.T, AVn,
                                     preferred_element_type=dt),)
            # A collapse rotates the Ritz frame but keeps the SAME
            # lowest pairs; the previous correction stays a valid guess.
            return _tail(out, inner_ops, corr_prev)

        def step(_):
            # Expansion iff current dim <= max_dim (``src/davidson.f90:195``).
            return jax.lax.cond(m <= cfg.max_dim, expand, collapse, None)

        new = jax.lax.cond(all_conv, no_update, step, None)
        if warm:
            new, corr_new = new[:-1], new[-1]
        if gjd:
            new, inner_new = new[:-1], new[-1]
        if fused:
            new, H_new = new[:-1], new[-1]
        if gen:
            Vn, AVn, BVn, mn, okn, opc = new
        else:
            Vn, AVn, mn, okn, opc = new

        # Fixed-point detection: in lowest-k mode an expansion that admits
        # zero columns leaves the state bit-identical (m, V, caches, masks
        # all unchanged), so the loop could never progress again. m is the
        # complete witness: expand changes it by `live`, collapse lowers
        # it, and the all_conv no-update case exits via all_conv anyway.
        if cfg.expansion == "lowest-k":
            stalled = (mn == m) & ~all_conv
        else:
            stalled = jnp.asarray(False)
        out = dict(
            V=Vn, AV=AVn, m=mn, col_ok=okn, it=it + 1,
            chunk_end=st["chunk_end"],
            has_conv=has_conv, all_conv=all_conv,
            evals=w_report[:k], evecs=X[:, :k], errors=errors,
            history=history, dims=dims, op_cols=opc,
            stalled=stalled,
        )
        if gjd:
            out["inner_ops"] = inner_new
        if warm:
            out["corr_prev"] = corr_new
        if fused:
            out["H"] = H_new
        if precise:
            # Plateau detection (see init_state): converged pairs are
            # excluded via has_conv so sticky semantics still win. A
            # collapse is NEUTRAL — the thin restart basis legitimately
            # needs recovery iterations that would otherwise read as
            # no-progress, but it must not RESET the counter: the
            # doubling schedule collapses every ~log2(max_dim/init_dim)
            # iterations (< _PLATEAU_ITERS for typical configs), and a
            # reset would make the plateau exit structurally unreachable
            # there, grinding noise to max_iterations at the f32 floor.
            worst = jnp.max(jnp.where(has_conv, 0.0, errors))
            improved = worst < st["best_err"] * (1.0 - 1e-2)
            collapsed = mn < m
            out["best_err"] = jnp.minimum(st["best_err"], worst)
            no_prog = jnp.where(improved, 0,
                                jnp.where(collapsed, st["no_prog"],
                                          st["no_prog"] + 1))
            out["no_prog"] = no_prog
            out["stalled"] = out["stalled"] | (no_prog >= _PLATEAU_ITERS)
            # Trial-polish certification (round 5): at the FIRST short
            # plateau, ask the polish whether the k pairs already
            # certify at the user's tolerance — the measured 10M
            # residual histories show the DS
            # polish closes to 1e-11 from the first f32-floor plateau
            # (~3e-4), so iterating past it is waste, and the noise
            # windows' exact firing time is chaotic in the
            # compensated-sum bit pattern. One polish evaluation (~one
            # iteration's worth of k-column applies) per plateau
            # episode; exits through the stall path, after which the
            # final polish re-runs the SAME computation on the same
            # vectors and re-checks convergence — the certification
            # here is exactly the contract the result will be held to.
            if cfg.final_polish > 0 and A_off is not None:
                from fortran_davidson_tpu.core import refine as _ref

                def _certify(args):
                    w_k, X_k = args
                    pol = _ref.polish(A_off, diag_a, w_k, X_k,
                                      iterations=cfg.final_polish,
                                      B_off=B_off,
                                      diag_b=diag_b if gen else None,
                                      update=cfg.polish_update)
                    if cfg.relative:
                        okc = pol.errors < cfg.tolerance * jnp.maximum(
                            jnp.abs(pol.evals), 1.0)
                    else:
                        okc = pol.errors < cfg.tolerance
                    return jnp.all(okc)

                # ~collapsed: collapse iterations FREEZE no_prog, so
                # without the guard every collapse while the counter
                # sits at the poll point would re-pay the polish.
                certified = jax.lax.cond(
                    (no_prog == _POLISH_POLL_AT) & ~collapsed, _certify,
                    lambda args: jnp.asarray(False),
                    (w_report[:k], X[:, :k]))
                out["stalled"] = out["stalled"] | certified
        if gen:
            out["BV"] = BVn
        if "spec_ub" in st:
            out["spec_ub"] = st["spec_ub"]
        if constrain is not None:
            out = constrain(out)
        return out

    # The context must be live while cond/body TRACE — i.e. around the
    # while_loop call itself (everything the solver computes per
    # iteration traces in here).
    with _precision_ctx(cfg):
        return jax.lax.while_loop(cond, body, state)


def pack_result(final: dict) -> DavidsonResult:
    return DavidsonResult(
        eigenvalues=final["evals"],
        eigenvectors=final["evecs"],
        iterations=final["it"],
        converged=final["all_conv"],
        converged_pairs=final["has_conv"],
        residual_norms=final["errors"],
        residual_history=final["history"],
        subspace_dims=final["dims"],
        operator_columns=final["op_cols"],
        stalled=final.get("stalled"),
        inner_iterations=final.get("inner_ops"),
    )


def _ds_strategy(constrain):
    """Tall-reduction strategy for code traced under this engine.

    Single-device engines use the streaming slab cascade; GSPMD-sharded
    engines (constrain pins row shardings) need the tree — the cascade's
    dynamic row slices would make the partitioner gather across shards
    every loop step — with SHARD-LOCAL pairing (row_divisor): the tree
    folds each device's rows locally and only (D, width) partials cross
    the mesh. See ``utils.ds.sum_strategy`` / ``_fold_leading``.
    """
    from fortran_davidson_tpu.utils import ds as dsm
    if constrain is None:
        return dsm.sum_strategy("cascade")
    return dsm.sum_strategy(
        "tree", row_divisor=getattr(constrain, "row_divisor", 1) or 1)


def _apply_final_polish(cfg: ResolvedConfig, A: LinearOperator,
                        B: Optional[LinearOperator], A_off, B_off,
                        res: DavidsonResult,
                        constrain=None) -> DavidsonResult:
    """Double-single polish of the k returned pairs + honest re-check.

    The loop's attainable residual is floored by f32 BASIS storage
    (measured ~3.5e-5 absolute at 10M rows); the polish holds the k
    vectors as hi/lo pairs and beats that floor by orders of magnitude.
    Convergence is re-evaluated against the polished TRUE residuals, so
    the result's contract (``converged`` == residuals below tolerance)
    holds at tolerances the loop alone cannot reach on f32 hardware.
    """
    from fortran_davidson_tpu.core import refine

    dt = jnp.dtype(cfg.dtype)
    diag_a = A.diagonal().astype(dt)
    diag_b = B.diagonal().astype(dt) if B is not None else None
    with _precision_ctx(cfg), _ds_strategy(constrain):
        pol = refine.polish(A_off, diag_a, res.eigenvalues,
                            res.eigenvectors,
                            iterations=cfg.final_polish,
                            B_off=B_off, diag_b=diag_b,
                            update=cfg.polish_update)
    if cfg.relative:
        conv = pol.errors < cfg.tolerance * jnp.maximum(
            jnp.abs(pol.evals), 1.0)
    else:
        conv = pol.errors < cfg.tolerance
    return DavidsonResult(
        eigenvalues=pol.evals,
        eigenvectors=pol.evecs_hi,
        iterations=res.iterations,
        converged=jnp.all(conv),
        converged_pairs=conv,
        residual_norms=pol.errors,
        residual_history=res.residual_history,
        subspace_dims=res.subspace_dims,
        # hi+lo both pass through A_off once per polish iteration.
        operator_columns=res.operator_columns
        + 2 * cfg.final_polish * cfg.lowest,
        stalled=res.stalled,
        inner_iterations=res.inner_iterations,
        eigenvalues_lo=pol.evals_lo,
    )


def _engine(cfg: ResolvedConfig, A: LinearOperator,
            B: Optional[LinearOperator],
            constrain=None, A_off=None, B_off=None,
            X0=None) -> DavidsonResult:
    with _ds_strategy(constrain):
        state = init_state(cfg, A, B, constrain=constrain, X0=X0)
        final = run_state(cfg, A, B, state, constrain=constrain,
                          A_off=A_off, B_off=B_off)
        res = pack_result(final)
        if cfg.final_polish > 0:
            res = _apply_final_polish(cfg, A, B, A_off, B_off, res,
                                      constrain=constrain)
    return res


class _LRUCache:
    """Bounded compiled-program cache.

    Engines are keyed by the full (config, constrain) pair, so a
    config-sweeping caller (tolerance ladders, hyperparameter scans)
    mints a new XLA executable per distinct configuration; unbounded,
    the accumulated executables exhaust host memory (observed: XLA:CPU
    aborting with a fatal compile error near the end of the full test
    suite before the suite grew per-module eviction). An LRU bound keeps
    hot configs compiled while cold executables lose their last
    reference and are freed with the jitted callable.

    Every instance registers itself so :func:`clear_compiled_caches` /
    :func:`set_compiled_cache_capacity` cover ALL compiled-program
    caches in the library (the batched solver keeps its own). The
    registry holds weak references: module-level singletons stay pinned
    by their modules, while any transiently created cache (tests,
    per-solver experiments) is dropped — not leaked with its compiled
    executables — once its last strong reference dies.
    """

    instances: weakref.WeakSet = weakref.WeakSet()

    def __init__(self, capacity: int):
        import collections
        self._d = collections.OrderedDict()
        self.capacity = capacity
        _LRUCache.instances.add(self)

    def get(self, key):
        value = self._d.get(key)
        if value is not None:
            self._d.move_to_end(key)
        return value

    def put(self, key, value):
        self._d[key] = value
        self._d.move_to_end(key)
        self._evict()

    def set_capacity(self, capacity: int):
        self.capacity = capacity
        self._evict()

    def _evict(self):
        while len(self._d) > max(1, self.capacity):
            self._d.popitem(last=False)

    def clear(self):
        self._d.clear()

    def __len__(self):
        return len(self._d)


_DEFAULT_CACHE_CAPACITY = int(
    os.environ.get("FDT_ENGINE_CACHE_SIZE", "32"))

_ENGINE_CACHE = _LRUCache(_DEFAULT_CACHE_CAPACITY)


def set_compiled_cache_capacity(capacity: int) -> None:
    """Bound how many compiled engine/stepper variants stay live.

    Each distinct (DavidsonOptions, sharding) pair compiles its own XLA
    executable; the default bound (32, or ``FDT_ENGINE_CACHE_SIZE``)
    suits typical workloads. Raise it for wide multi-config services,
    lower it (even to 1) for memory-constrained sweeps.
    """
    if capacity < 1:
        raise ValueError("cache capacity must be >= 1")
    for cache in _LRUCache.instances:
        cache.set_capacity(capacity)


def clear_compiled_caches() -> None:
    """Drop every cached compiled program in the library — engines,
    steppers, and the batched solver's vmapped programs (their
    executables are freed with the last reference). The library-level
    mechanism behind long config sweeps; tests clear per module via
    this hook."""
    for cache in _LRUCache.instances:
        cache.clear()


def get_engine(cfg: ResolvedConfig, constrain=None):
    """Compiled engine for a configuration (cached; operators are traced).

    ``constrain`` is an optional hashable callable applied to the loop
    state at initialization and after every body step — the distributed
    layer uses it to pin ``jax.sharding`` layouts (row-sharded V/AV/BV)
    so GSPMD's fixed-point propagation cannot silently replicate the tall
    arrays (see ``fortran_davidson_tpu.parallel.sharded``).
    """
    key = (cfg, constrain)
    fn = _ENGINE_CACHE.get(key)
    if fn is None:
        def run(A, B, A_off=None, B_off=None, X0=None):
            return _engine(cfg, A, B, constrain=constrain,
                           A_off=A_off, B_off=B_off, X0=X0)
        fn = jax.jit(run)
        _ENGINE_CACHE.put(key, fn)
    return fn


_STEPPER_CACHE = _LRUCache(_DEFAULT_CACHE_CAPACITY)


def get_stepper(cfg: ResolvedConfig, constrain=None):
    """(init, step) pair of jitted functions over an explicit state pytree.

    ``init(A, B) -> state``; ``step(A, B, state) -> state`` iterates up to
    ``state['chunk_end']``. The explicit state is what enables
    checkpoint/resume and per-chunk observability without giving up the
    compiled while_loop.
    """
    key = (cfg, constrain)
    pair = _STEPPER_CACHE.get(key)
    if pair is None:
        def init_fn(A, B, X0=None):
            with _ds_strategy(constrain):
                return init_state(cfg, A, B, constrain=constrain, X0=X0)

        def step_fn(A, B, st, A_off=None, B_off=None):
            with _ds_strategy(constrain):
                return run_state(cfg, A, B, st, constrain=constrain,
                                 A_off=A_off, B_off=B_off)

        pair = (jax.jit(init_fn), jax.jit(step_fn))
        _STEPPER_CACHE.put(key, pair)
    return pair


def run_chunked(cfg: ResolvedConfig, A: LinearOperator,
                B: Optional[LinearOperator], *, every: int,
                callbacks=(), state: Optional[dict] = None,
                constrain=None, A_off=None,
                B_off=None, X0=None) -> DavidsonResult:
    """Chunked driver: run ``every`` iterations per device dispatch, then
    sync to host and invoke ``callbacks(state)`` — the hook point for
    checkpointing, convergence logging, and profiler steps. Semantics are
    identical to the one-shot engine (the while_loop's exit conditions
    are re-evaluated on device inside every chunk)."""
    init, step = get_stepper(cfg, constrain)
    if cfg.refined and A_off is None:
        A_off = A.offdiag()
        B_off = B.offdiag() if B is not None else None
    st = init(A, B, X0) if state is None else state
    it = int(st["it"])
    while True:
        end = min(it + every, cfg.max_iterations)
        st = dict(st)
        st["chunk_end"] = jnp.asarray(end, jnp.int32)
        st = step(A, B, st, A_off, B_off)
        it = int(st["it"])  # host sync once per chunk
        for cb in callbacks:
            cb(st)
        if (bool(st["all_conv"]) or bool(st.get("stalled", False))
                or it >= cfg.max_iterations):
            res = pack_result(st)
            if cfg.final_polish > 0:
                res = _apply_final_polish(cfg, A, B, A_off, B_off, res,
                                          constrain=constrain)
            return res

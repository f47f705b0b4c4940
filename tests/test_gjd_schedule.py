"""Adaptive GJD inner stopping (round-3 upgrade over the reference).

The reference solves every GJD correction equation *exactly* with DSYSV
(``src/davidson.f90:719-732``) — inexactness-blind O(n^3) work per pair
per outer iteration. This engine's inner MINRES gets two stopping
upgrades instead:

1. an outer-target-linked absolute forcing term (inexact JD): the inner
   solve stops once its residual falls an order below the outer
   tolerance, which preserves the exact-solve outer trajectory by
   construction (``core/loop.py`` GJD branch);
2. a per-column no-progress cutoff inside MINRES that stops the grind at
   the floating-point attainable floor instead of burning the full
   iteration cap with a flat residual (``core/krylov.py:_stall_params``)
   — the dominant cost of f32 GJD at scale.

These tests pin that the schedule never changes outer iteration counts
on the reference-parity problems, and that the stall cutoff actually
fires on a floor-limited solve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fortran_davidson_tpu import DavidsonOptions, eigensolve
from fortran_davidson_tpu.config import InvalidOptionsError
from fortran_davidson_tpu.core.krylov import _stall_params, minres_block
from fortran_davidson_tpu.models.generators import generate_diagonal_dominant


def test_schedule_validation():
    with pytest.raises(InvalidOptionsError):
        DavidsonOptions(gjd_inner_schedule="geometric")


@pytest.mark.parametrize("gen", [False, True])
def test_adaptive_matches_fixed_outer_trajectory(gen):
    """The forcing term is invisible to the outer loop: iteration counts
    (the reference-parity observable) match the exact-solve schedule."""
    n, k = 50, 3
    A = generate_diagonal_dominant(n, 1e-3, key=jax.random.PRNGKey(n + k))
    B = None
    if gen:
        B = generate_diagonal_dominant(n, 1e-3, diag_val=1.0,
                                       key=jax.random.PRNGKey(n + k + 1))
    runs = {}
    for sched in ("fixed", "adaptive"):
        res = eigensolve(A, k, second_matrix=B, method="GJD",
                         tolerance=1e-8, max_dim_sub=10, max_iterations=100,
                         options=DavidsonOptions(gjd_inner_schedule=sched))
        assert bool(res.converged)
        runs[sched] = res
    assert int(runs["adaptive"].iterations) == int(runs["fixed"].iterations)
    np.testing.assert_allclose(np.asarray(runs["adaptive"].eigenvalues),
                               np.asarray(runs["fixed"].eigenvalues),
                               atol=1e-8)


def test_relative_tolerance_forcing_converges():
    """The forcing term scales by |theta| under relative_tolerance."""
    n, k = 60, 2
    A = generate_diagonal_dominant(n, 1e-3, key=jax.random.PRNGKey(7))
    res = eigensolve(A, k, method="GJD", tolerance=1e-9, max_dim_sub=12,
                     max_iterations=100,
                     options=DavidsonOptions(relative_tolerance=True))
    assert bool(res.converged)


def test_minres_percolumn_rtol():
    """Per-column relative tolerances: each column meets ITS target."""
    rng = np.random.default_rng(3)
    n = 80
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = Q @ np.diag(np.linspace(1.0, 50.0, n)) @ Q.T
    A = jnp.asarray(A)
    b = jnp.asarray(rng.standard_normal((n, 2)))
    rtol = jnp.asarray([1e-10, 1e-3])
    x = minres_block(lambda T: A @ T, b, maxiter=200, rtol=rtol)
    res = np.linalg.norm(np.asarray(A @ x - b), axis=0)
    bn = np.linalg.norm(np.asarray(b), axis=0)
    assert res[0] <= 1e-9 * bn[0]
    assert res[1] <= 1e-2 * bn[1]


def test_minres_stall_cutoff_fires_at_f32_floor():
    """An f32 solve asked for an unattainable tolerance stops at its
    attainable floor instead of burning the full iteration cap."""
    rng = np.random.default_rng(11)
    n = 120
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    # Condition number ~1e4: the f32 attainable relative residual
    # (~eps * cond ~ 1e-3) is far above the requested 1e-12.
    A = (Q @ np.diag(np.geomspace(1.0, 1e4, n)) @ Q.T).astype(np.float32)
    A = jnp.asarray(A)
    b = jnp.asarray(rng.standard_normal((n, 3)).astype(np.float32))
    x, iters = minres_block(lambda T: A @ T, b, maxiter=5000, rtol=1e-12,
                            return_iters=True)
    assert int(iters) < 5000, "stall cutoff should fire before the cap"
    # The early exit still delivers a floor-quality solution.
    res = np.linalg.norm(np.asarray(A @ x - b), axis=0)
    bn = np.linalg.norm(np.asarray(b), axis=0)
    assert np.all(res <= 1e-2 * bn)


def test_minres_stall_window_no_false_trigger_f64():
    """Well-conditioned f64 solves converge to tight tolerances — the
    window must never freeze a still-progressing column."""
    rng = np.random.default_rng(5)
    n = 150
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = jnp.asarray(Q @ np.diag(np.linspace(1.0, 100.0, n)) @ Q.T)
    b = jnp.asarray(rng.standard_normal((n, 4)))
    x = minres_block(lambda T: A @ T, b, maxiter=2000, rtol=1e-12)
    res = np.linalg.norm(np.asarray(A @ x - b), axis=0)
    bn = np.linalg.norm(np.asarray(b), axis=0)
    assert np.all(res <= 1e-11 * bn)
    assert _stall_params(jnp.float64)[0] >= 4


def test_inner_iterations_telemetry():
    """GJD solves report cumulative inner-MINRES iterations — the cost
    metric the adaptive schedule reduces; DPR reports None."""
    from fortran_davidson_tpu import eigensolve
    from fortran_davidson_tpu.models.generators import (
        generate_diagonal_dominant)
    A = generate_diagonal_dominant(200, 1e-3)
    r = eigensolve(A, 2, method="GJD", tolerance=1e-9)
    assert r.inner_iterations is not None
    assert int(r.inner_iterations) > 0
    r_dpr = eigensolve(A, 2, method="DPR", tolerance=1e-9)
    assert r_dpr.inner_iterations is None

    # The adaptive schedule must never spend MORE inner work than the
    # fixed one at matched outer iteration counts.
    import jax.numpy as jnp
    from fortran_davidson_tpu.models.generators import (
        surrogate_hamiltonian)
    op = surrogate_hamiltonian(2048, dtype=jnp.float32)
    ad = eigensolve(op, 2, method="GJD", tolerance=1e-5, dtype="float32",
                    refined=True, gjd_inner_schedule="adaptive")
    fx = eigensolve(op, 2, method="GJD", tolerance=1e-5, dtype="float32",
                    refined=True, gjd_inner_schedule="fixed")
    assert int(ad.inner_iterations) <= int(fx.inner_iterations)


def test_minres_rate_cutoff_on_slow_progress():
    """The stall bar is a sustained-progress-RATE requirement: a column
    creeping at ~0.5%/iter (real but worthless progress — measured at
    the 10M f32 scale grinding ~119 of the 128-iteration cap to buy a
    ~30% residual improvement) must be cut well before the cap, while a
    healthy column still converges to its tolerance."""
    window32, improvement32 = _stall_params(jnp.float32)
    # The f32 bar must demand a real rate (>= ~1%/iter) over a window
    # long enough that early superlinear lag does not false-trigger.
    assert improvement32 / window32 >= 0.01
    assert window32 >= 8

    n = 400
    # Column 0: well-conditioned SPD system. Column 1: condition ~1e8 in
    # f32 — MINRES progress per iteration is microscopic, the f32 floor.
    d_good = jnp.linspace(1.0, 2.0, n).astype(jnp.float32)
    d_bad = jnp.logspace(-4, 4, n).astype(jnp.float32)

    def matvec(X):
        return jnp.stack([d_good * X[:, 0], d_bad * X[:, 1]], axis=1)

    b = jnp.ones((n, 2), jnp.float32)
    x, iters = minres_block(matvec, b, maxiter=4096, rtol=1e-6,
                            return_iters=True)
    # The healthy column's solution is accurate...
    r0 = float(jnp.linalg.norm(d_good * x[:, 0] - b[:, 0]))
    assert r0 <= 1e-5 * float(jnp.linalg.norm(b[:, 0]))
    # ...and the floor-limited column was cut far below the cap instead
    # of grinding thousands of worthless iterations.
    assert int(iters) < 1024


def test_gjd_warm_start_cuts_inner_work_same_outer_trajectory():
    """gjd_warm_start recycles the previous outer iteration's correction
    as the inner solve's initial guess: cumulative inner MINRES work (the
    GJD-at-scale cost) drops while the outer trajectory — iteration
    count, eigenvalues, converged residuals — is preserved (the guess is
    solved to the same absolute target)."""
    from fortran_davidson_tpu.models.generators import surrogate_hamiltonian
    op = surrogate_hamiltonian(20096, dtype=jnp.float32)
    common = dict(method="GJD", tolerance=1e-8, relative_tolerance=True,
                  dtype="float32", refined=True, final_polish=2,
                  gjd_preconditioner="dpr", expansion="lowest-k",
                  max_iterations=40)
    cold = eigensolve(op, 3, gjd_warm_start=False, **common)
    warm = eigensolve(op, 3, gjd_warm_start=True, **common)
    assert bool(cold.converged) and bool(warm.converged)
    assert int(warm.iterations) == int(cold.iterations)
    assert int(warm.inner_iterations) < int(cold.inner_iterations)
    np.testing.assert_allclose(np.asarray(warm.eigenvalues),
                               np.asarray(cold.eigenvalues),
                               rtol=1e-6, atol=1e-8)


def test_gjd_warm_start_parity_pins_hold():
    """With warm start ON, small f64 parity problems keep their exact
    outer iteration counts (the recycled guess changes only how the
    inner solve reaches the same tolerance)."""
    A = generate_diagonal_dominant(50, 1e-3, key=jax.random.PRNGKey(53))
    base = eigensolve(A, 3, method="GJD", tolerance=1e-8, max_dim_sub=10,
                      max_iterations=100)
    warm = eigensolve(A, 3, method="GJD", tolerance=1e-8, max_dim_sub=10,
                      max_iterations=100, gjd_warm_start=True)
    assert int(warm.iterations) == int(base.iterations)
    np.testing.assert_allclose(np.asarray(warm.eigenvalues),
                               np.asarray(base.eigenvalues), atol=1e-10)


def test_minres_f64_slow_but_real_progress_not_cut():
    """The sustained-rate bar is f32-gated (advisor r3): an f64 solve
    making real-but-slow progress (~0.6%/iter on a cond~1e5 operator —
    far below the f32 bar's ~1.8%/iter) must run to its tight tolerance
    instead of being frozen at a ~10% improvement. Under the f32
    parameters this exact solve IS cut (16 iterations buy ~10% < 25%);
    f64 keeps the fine no-progress detector only."""
    window64, improvement64 = _stall_params(jnp.float64)
    assert (window64, improvement64) != _stall_params(jnp.float32)
    n = 200
    d = jnp.asarray(np.geomspace(1e-5, 1.0, n))  # cond 1e5, SPD
    b = jnp.ones((n, 1), jnp.float64)
    x, iters = minres_block(lambda T: d[:, None] * T, b, maxiter=8000,
                            rtol=1e-10, return_iters=True)
    r = float(jnp.linalg.norm(d[:, None] * x - b))
    assert r <= 1e-9 * float(jnp.linalg.norm(b))
    # Sanity: this really is a slow solve that a 16-iteration rate bar
    # would have frozen long before convergence.
    assert int(iters) > 200

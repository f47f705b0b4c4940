"""Unit tests for the numerics substrate (tier 1 of the reference's test
strategy, cross-validated against numpy/scipy from day one — SURVEY §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg

from fortran_davidson_tpu.core import orthogonal, subspace
from fortran_davidson_tpu.models.generators import generate_diagonal_dominant
from fortran_davidson_tpu.ops.operators import (
    DenseOperator, DiagonalOperator, MatrixFreeOperator, as_operator,
    probe_diagonal)


def test_generate_diagonal_dominant_matches_reference_semantics():
    A = np.asarray(generate_diagonal_dominant(50, 1e-3))
    assert np.allclose(A, A.T)
    assert np.allclose(np.diag(A), np.arange(1, 51))
    off = A - np.diag(np.diag(A))
    assert np.abs(off).max() <= 1e-3
    B = np.asarray(generate_diagonal_dominant(50, 1e-3, diag_val=1.0,
                                              key=jax.random.PRNGKey(7)))
    assert np.allclose(np.diag(B), 1.0)


def test_dense_operator_matmat():
    A = generate_diagonal_dominant(20, 1e-2)
    op = DenseOperator(A)
    X = jax.random.normal(jax.random.PRNGKey(0), (20, 4), dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(op.matmat(X)),
                               np.asarray(A) @ np.asarray(X), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(op.diagonal()),
                               np.diag(np.asarray(A)))


def test_diagonal_operator():
    d = jnp.arange(1.0, 11.0)
    op = DiagonalOperator(d)
    X = jnp.ones((10, 3), jnp.float64)
    np.testing.assert_allclose(np.asarray(op.matmat(X)),
                               np.asarray(d)[:, None] * np.ones((10, 3)))


@pytest.mark.parametrize("n", [64, 100, 130])
def test_probe_diagonal(n):
    A = generate_diagonal_dominant(n, 1e-2)
    diag = probe_diagonal(lambda X: A @ X, n, jnp.float64, block=64)
    np.testing.assert_allclose(np.asarray(diag), np.diag(np.asarray(A)),
                               rtol=1e-12)


def test_matrix_free_operator_diag_fallback():
    A = generate_diagonal_dominant(30, 1e-3)
    op = MatrixFreeOperator(lambda X: A @ X, 30)
    np.testing.assert_allclose(np.asarray(op.diagonal()),
                               np.diag(np.asarray(A)), rtol=1e-12)


def test_as_operator_coercion():
    assert isinstance(as_operator(np.eye(4)), DenseOperator)
    assert isinstance(as_operator(np.ones(4)), DiagonalOperator)
    op = DenseOperator(jnp.eye(3))
    assert as_operator(op) is op


def test_initial_subspace_matches_reference_preconditioner():
    # Reference: column i = e_{p_i}, p_i = index of i-th smallest diagonal
    # entry (src/array_utils.f90:136-160).
    diag = jnp.asarray([5.0, 1.0, 3.0, 2.0, 4.0])
    V = np.asarray(subspace.initial_subspace(diag, 3, 4))
    assert V.shape == (5, 4)
    expected = np.zeros((5, 4))
    expected[1, 0] = 1.0  # smallest diag entry at index 1
    expected[3, 1] = 1.0
    expected[2, 2] = 1.0
    np.testing.assert_allclose(V, expected)


def test_masked_eigh_matches_unpadded():
    n, m, m_max = 40, 5, 8
    A = np.asarray(generate_diagonal_dominant(n, 1e-2))
    Vfull = np.linalg.qr(np.random.default_rng(0).normal(size=(n, m)))[0]
    V = np.zeros((n, m_max))
    V[:, :m] = Vfull
    H = jnp.asarray(V.T @ A @ V)
    mask = (jnp.arange(m_max) < m).astype(jnp.float64)
    w, W = subspace.masked_eigh(H, mask)
    w_ref = np.linalg.eigvalsh(Vfull.T @ A @ Vfull)
    np.testing.assert_allclose(np.asarray(w[:m]), w_ref, rtol=1e-12)
    # Active eigenvectors live entirely in the active block.
    assert np.abs(np.asarray(W)[m:, :m]).max() < 1e-10


def test_masked_generalized_eigh_matches_scipy():
    n, m, m_max = 40, 6, 8
    rng = np.random.default_rng(1)
    A = np.asarray(generate_diagonal_dominant(n, 1e-2))
    B = np.asarray(generate_diagonal_dominant(n, 1e-3, diag_val=1.0,
                                              key=jax.random.PRNGKey(3)))
    Vfull = np.linalg.qr(rng.normal(size=(n, m)))[0]
    V = np.zeros((n, m_max))
    V[:, :m] = Vfull
    H = jnp.asarray(V.T @ A @ V)
    S = jnp.asarray(V.T @ B @ V)
    mask = (jnp.arange(m_max) < m).astype(jnp.float64)
    w, W = subspace.masked_generalized_eigh(H, S, mask)
    w_ref, W_ref = scipy.linalg.eigh(np.asarray(H)[:m, :m],
                                     np.asarray(S)[:m, :m])
    np.testing.assert_allclose(np.asarray(w[:m]), w_ref, rtol=1e-10)
    # B-orthonormality, like DSYGV.
    WS = np.asarray(W)[:m, :m]
    np.testing.assert_allclose(WS.T @ np.asarray(S)[:m, :m] @ WS, np.eye(m),
                               atol=1e-10)


def test_orthonormalize_block():
    n, m, b, m_max = 50, 4, 4, 8
    rng = np.random.default_rng(2)
    V = np.zeros((n, m_max))
    V[:, :m] = np.linalg.qr(rng.normal(size=(n, m)))[0]
    C = np.zeros((n, m_max))
    C[:, :b] = rng.normal(size=(n, b))
    mask = (jnp.arange(m_max) < b).astype(jnp.float64)
    Q, alive = orthogonal.orthonormalize_block(jnp.asarray(V),
                                               jnp.asarray(C), mask)
    Q = np.asarray(Q)
    assert np.asarray(alive)[:b].sum() == b  # full-rank block survives
    # Masked columns exactly zero.
    assert np.all(Q[:, b:] == 0)
    # Orthonormal and orthogonal to V.
    np.testing.assert_allclose(Q[:, :b].T @ Q[:, :b], np.eye(b), atol=1e-12)
    assert np.abs(V[:, :m].T @ Q[:, :b]).max() < 1e-12
    # Same span as the projected block.
    P = np.eye(n) - V[:, :m] @ V[:, :m].T
    C_perp = P @ C[:, :b]
    resid = C_perp - Q[:, :b] @ (Q[:, :b].T @ C_perp)
    assert np.abs(resid).max() < 1e-10


def test_right_tri_solve():
    rng = np.random.default_rng(3)
    Y = rng.normal(size=(20, 5))
    R = np.triu(rng.normal(size=(5, 5))) + 5 * np.eye(5)
    X = np.asarray(orthogonal.right_tri_solve(jnp.asarray(Y), jnp.asarray(R)))
    np.testing.assert_allclose(X @ R, Y, atol=1e-12)


class TestCholeskyQR2:
    def test_matches_householder_span(self, rng):
        import jax.numpy as jnp
        from fortran_davidson_tpu.core.orthogonal import cholqr2
        X = jnp.asarray(rng.standard_normal((200, 12)))
        Q, R = cholqr2(X)
        np.testing.assert_allclose(np.asarray(Q.T @ Q), np.eye(12),
                                   atol=1e-13)
        np.testing.assert_allclose(np.asarray(Q @ R), np.asarray(X),
                                   atol=1e-12)
        assert np.allclose(np.triu(np.asarray(R)), np.asarray(R))

    def test_padded_zero_columns_pass_through(self, rng):
        import jax.numpy as jnp
        from fortran_davidson_tpu.core.orthogonal import cholqr2
        X = jnp.asarray(rng.standard_normal((50, 8)))
        mask = jnp.asarray([1.0] * 5 + [0.0] * 3)
        Xm = X * mask[None, :]
        Q, _ = cholqr2(Xm, unit_diag=mask)
        Qn = np.asarray(Q)
        assert np.all(Qn[:, 5:] == 0)
        np.testing.assert_allclose(Qn[:, :5].T @ Qn[:, :5], np.eye(5),
                                   atol=1e-13)

    def test_qr_and_cholqr2_same_iteration_counts(self):
        import fortran_davidson_tpu as fdt
        from fortran_davidson_tpu.models.generators import \
            generate_diagonal_dominant
        A = generate_diagonal_dominant(80, 1e-3)
        r1 = fdt.eigensolve(A, 3, orthonormalization="cholqr2")
        r2 = fdt.eigensolve(A, 3, orthonormalization="qr")
        assert int(r1.iterations) == int(r2.iterations)
        np.testing.assert_allclose(np.asarray(r1.eigenvalues),
                                   np.asarray(r2.eigenvalues), atol=1e-10)


class TestRelativeTolerance:
    def test_relative_scales_with_eigenvalue(self):
        import fortran_davidson_tpu as fdt
        from fortran_davidson_tpu.models.generators import \
            generate_diagonal_dominant
        A = generate_diagonal_dominant(120, 1e-3) * 1e6  # huge spectrum
        res = fdt.eigensolve(A, 3, tolerance=1e-10, relative_tolerance=True,
                             max_iterations=60)
        res.block_until_ready()
        assert bool(res.converged)
        lam = np.abs(np.asarray(res.eigenvalues))
        assert np.all(np.asarray(res.residual_norms) < 1e-10 * np.maximum(lam, 1))


class TestWideSpectrumFloat32:
    """Wide-spectrum (diag ~ n) float32 solves at scale: arbitrary basis
    completions or surviving cancellation noise inflate ||H|| and destroy
    the projected eigh's resolution of the low eigenvalues (observed as
    NaN / residuals regressing to 1e-1 at n >= 1M). SVQB dropping +
    the ratio drop test keep the basis low-energy."""

    def test_rank_deficient_corrections_converge(self):
        import jax.numpy as jnp
        import fortran_davidson_tpu as fdt
        from fortran_davidson_tpu.models.generators import \
            surrogate_hamiltonian
        # The separable surrogate has numerically rank-2 correction
        # blocks — the hard case. 100k rows keeps CPU runtime small while
        # still exhibiting the failure with filler-style completion.
        op = surrogate_hamiltonian(100_096, dtype=jnp.float32)
        res = fdt.eigensolve(op, 4, method="DPR", tolerance=1e-3,
                             max_iterations=30, dtype="float32",
                             relative_tolerance=True)
        res.block_until_ready()
        assert bool(res.converged)
        lam = np.abs(np.asarray(res.eigenvalues))
        assert np.all(np.asarray(res.residual_norms)
                      < 1e-3 * np.maximum(lam, 1))
        np.testing.assert_allclose(np.asarray(res.eigenvalues),
                                   [1.0, 2.0, 3.0, 4.0], atol=2e-3)
        # Residual history must be monotone-ish: no catastrophic regression
        # after expansions (the failure signature).
        h = np.asarray(res.residual_history)
        h = h[: int(res.iterations)]
        assert not np.isnan(h).any()

    def test_svqb_drops_rank_deficiency(self, rng):
        import jax.numpy as jnp
        from fortran_davidson_tpu.core.orthogonal import svqb
        # 6 masked columns spanning only a 2-D space.
        U = rng.standard_normal((50, 2))
        C = rng.standard_normal((2, 6))
        block = jnp.asarray(U @ C)
        mask = jnp.asarray([1.0] * 6 + [0.0] * 2)
        block = jnp.pad(block, ((0, 0), (0, 2))) * mask[None, :]
        Q = np.asarray(svqb(block, mask))
        norms = np.linalg.norm(Q, axis=0)
        assert (norms > 0.5).sum() == 2          # numerical rank kept
        assert np.all(norms[2:] < 1e-12)         # compacted prefix
        kept = Q[:, :2]
        np.testing.assert_allclose(kept.T @ kept, np.eye(2), atol=1e-12)
        # kept spans the column space
        P = kept @ kept.T
        B = np.asarray(block[:, :6])
        np.testing.assert_allclose(P @ B, B, atol=1e-10)


class TestGJDPreconditioner:
    def test_dpr_scaling_converges_to_same_answer(self):
        import fortran_davidson_tpu as fdt
        from fortran_davidson_tpu.models.generators import \
            generate_diagonal_dominant
        A = generate_diagonal_dominant(60, 1e-3)
        base = fdt.eigensolve(A, 3, method="GJD", tolerance=1e-8)
        pre = fdt.eigensolve(A, 3, method="GJD", tolerance=1e-8,
                             gjd_preconditioner="dpr", max_iterations=200)
        assert bool(base.converged) and bool(pre.converged)
        np.testing.assert_allclose(np.asarray(pre.eigenvalues),
                                   np.asarray(base.eigenvalues), atol=1e-8)

    def test_unknown_preconditioner_raises(self):
        import fortran_davidson_tpu as fdt
        import pytest as _pytest
        from fortran_davidson_tpu.utils.errors import InvalidOptionsError
        with _pytest.raises(InvalidOptionsError):
            fdt.DavidsonOptions(gjd_preconditioner="wat")


class TestMatmulPrecision:
    """The solver pins XLA matmul precision for f32 solves (a default
    that demotes f32 operands, TF32 on GPUs, poisons the Gram/Ritz/
    residual matmuls and the GJD inner Krylov). A no-op on CPU, but
    resolution and plumbing are testable everywhere."""

    def test_resolution_defaults(self):
        from fortran_davidson_tpu.config import (DavidsonOptions,
                                                 resolve_options)
        f32 = resolve_options(DavidsonOptions(dtype="float32"), 3, 100,
                              False)
        f64 = resolve_options(DavidsonOptions(), 3, 100, False)
        over = resolve_options(
            DavidsonOptions(dtype="float32", matmul_precision="bfloat16"),
            3, 100, False)
        assert f32.matmul_precision == "float32"
        assert f64.matmul_precision is None
        assert over.matmul_precision == "bfloat16"

    def test_invalid_precision_raises(self):
        import pytest as _pytest
        from fortran_davidson_tpu.config import DavidsonOptions
        from fortran_davidson_tpu.utils.errors import InvalidOptionsError
        with _pytest.raises(InvalidOptionsError):
            DavidsonOptions(matmul_precision="quad")

    def test_solve_under_explicit_precision(self):
        # End-to-end through the engine with the context active (CPU: the
        # context parses and traces; numerics are unchanged).
        import fortran_davidson_tpu as fdt
        from fortran_davidson_tpu.models.generators import \
            generate_diagonal_dominant
        A = generate_diagonal_dominant(60, 1e-3)
        base = fdt.eigensolve(A, 3, tolerance=1e-8)
        pinned = fdt.eigensolve(A, 3, tolerance=1e-8,
                                matmul_precision="highest")
        assert bool(pinned.converged)
        np.testing.assert_allclose(np.asarray(pinned.eigenvalues),
                                   np.asarray(base.eigenvalues), atol=1e-10)


class TestLowestKExpansion:
    def test_smaller_padded_width(self):
        from fortran_davidson_tpu.config import (DavidsonOptions,
                                                 resolve_options)
        doubling = resolve_options(DavidsonOptions(), 20, 10000, False)
        lowk = resolve_options(DavidsonOptions(expansion="lowest-k"), 20,
                               10000, False)
        assert doubling.m_max == 320 and lowk.m_max == 220

    def test_converges_to_scipy(self):
        import scipy.linalg
        import fortran_davidson_tpu as fdt
        from fortran_davidson_tpu.models.generators import \
            generate_diagonal_dominant
        A = generate_diagonal_dominant(120, 1e-3)
        res = fdt.eigensolve(A, 4, expansion="lowest-k", tolerance=1e-8,
                             max_iterations=200)
        res.block_until_ready()
        assert bool(res.converged)
        expected = scipy.linalg.eigh(np.asarray(A), eigvals_only=True)[:4]
        np.testing.assert_allclose(np.asarray(res.eigenvalues), expected,
                                   atol=1e-8)
        # Dimension schedule grows by k per iteration until collapse.
        dims = np.asarray(res.subspace_dims)[: int(res.iterations)]
        steps = np.diff(dims[dims > 0])
        assert np.all((steps == 4) | (steps < 0))

    def test_generalized_gjd_lowest_k(self):
        import scipy.linalg
        import fortran_davidson_tpu as fdt
        from fortran_davidson_tpu.models.generators import \
            generate_diagonal_dominant
        A = generate_diagonal_dominant(60, 1e-3)
        B = generate_diagonal_dominant(60, 1e-3, diag_val=1.0)
        res = fdt.eigensolve(A, 3, second_matrix=B, method="GJD",
                             expansion="lowest-k", tolerance=1e-8,
                             max_iterations=200)
        res.block_until_ready()
        assert bool(res.converged)
        expected = scipy.linalg.eigh(np.asarray(A), np.asarray(B),
                                     eigvals_only=True)[:3]
        np.testing.assert_allclose(np.asarray(res.eigenvalues), expected,
                                   atol=1e-8)


import fortran_davidson_tpu as fdt  # noqa: E402


class TestDegenerateEigenvalues:
    """Exactly repeated lowest eigenvalues: the solver must find the
    full degenerate eigenspace (any orthonormal basis of it), report
    the repeated eigenvalue for each pair, and stay orthonormal."""

    def _degenerate_problem(self, n=80, mult=3):
        rng = np.random.default_rng(7)
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        d = np.arange(1.0, n + 1.0)
        d[:mult] = 1.0  # mult-fold degenerate lowest eigenvalue
        return Q * d[None, :] @ Q.T, d

    @pytest.mark.parametrize("method", ["DPR", "GJD", "OLSEN"])
    def test_degenerate_lowest(self, method):
        A, d = self._degenerate_problem()
        A = 0.5 * (A + A.T)
        res = fdt.eigensolve(jnp.asarray(A), 4, method=method,
                             tolerance=1e-8, max_iterations=300)
        assert bool(res.converged)
        want = np.sort(np.linalg.eigvalsh(A))[:4]
        np.testing.assert_allclose(np.asarray(res.eigenvalues), want,
                                   atol=1e-8)
        V = np.asarray(res.eigenvectors)
        # Orthonormality across the degenerate block.
        np.testing.assert_allclose(V.T @ V, np.eye(4), atol=1e-8)
        # Residuals of each pair against the true matrix.
        lam = np.asarray(res.eigenvalues)
        r = A @ V - V * lam[None, :]
        assert np.linalg.norm(r, axis=0).max() < 1e-7

    def test_identity_matrix_all_degenerate(self):
        # Total degeneracy: every eigenvalue 1. Must converge instantly
        # with an orthonormal basis.
        n = 40
        res = fdt.eigensolve(jnp.eye(n), 3, tolerance=1e-10,
                             max_iterations=50)
        assert bool(res.converged)
        np.testing.assert_allclose(np.asarray(res.eigenvalues),
                                   np.ones(3), atol=1e-12)
        V = np.asarray(res.eigenvectors)
        np.testing.assert_allclose(V.T @ V, np.eye(3), atol=1e-10)

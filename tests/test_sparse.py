"""Sparse operator layer: ELL and BSR layouts, Pallas SpMM kernel.

The reference has no sparse formats (its only large-operator path is the
on-the-fly row generator, ``src/davidson.f90:526-569``); these tests pin
the sparse layer against dense ground truth and run the full Davidson
solve through each format.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg

import fortran_davidson_tpu as fdt
from fortran_davidson_tpu.models.generators import generate_diagonal_dominant
from fortran_davidson_tpu.ops.pallas_kernels import banded_spmm
from fortran_davidson_tpu.utils.errors import OperatorError
from fortran_davidson_tpu.ops.sparse import (BSROperator, ELLOperator,
                                             generate_banded_bsr,
                                             generate_sparse_diagonal_dominant)


def _random_sym_coo(n, nnz, rng):
    i = rng.integers(0, n, nnz)
    j = rng.integers(0, n, nnz)
    v = rng.random(nnz)
    rows = np.concatenate([i, j, np.arange(n)])
    cols = np.concatenate([j, i, np.arange(n)])
    vals = np.concatenate([v, v, np.full(n, 10.0 + n)])
    return rows, cols, vals


class TestELL:
    def test_roundtrip_matches_dense(self, rng):
        n = 37
        rows, cols, vals = _random_sym_coo(n, 120, rng)
        op = ELLOperator.from_coo(rows, cols, vals, n)
        dense = np.zeros((n, n))
        np.add.at(dense, (rows, cols), vals)
        np.testing.assert_allclose(np.asarray(op.to_dense()), dense, atol=1e-12)
        np.testing.assert_allclose(np.asarray(op.diagonal()),
                                   np.diagonal(dense), atol=1e-12)

    @pytest.mark.parametrize("chunk", [1, 3, 8, 64])
    def test_matmat_chunking(self, rng, chunk):
        n = 53
        rows, cols, vals = _random_sym_coo(n, 200, rng)
        op = ELLOperator.from_coo(rows, cols, vals, n, chunk=chunk)
        X = rng.standard_normal((n, 7))
        expected = np.asarray(op.to_dense()) @ X
        np.testing.assert_allclose(np.asarray(op.matmat(jnp.asarray(X))),
                                   expected, atol=1e-10)

    def test_from_csr(self, rng):
        n = 20
        dense = np.array(generate_diagonal_dominant(n, 1e-2))
        dense[np.abs(dense) < 1e-6] = 0.0
        nz_mask = dense != 0
        indptr = np.concatenate([[0], np.cumsum(nz_mask.sum(1))])
        indices = np.nonzero(nz_mask)[1]
        data = dense[nz_mask]
        op = ELLOperator.from_csr(indptr, indices, data)
        np.testing.assert_allclose(np.asarray(op.to_dense()), dense, atol=1e-12)

    def test_duplicate_coo_entries_summed(self):
        op = ELLOperator.from_coo([0, 0, 1], [1, 1, 0], [2.0, 3.0, 5.0], 2)
        dense = np.asarray(op.to_dense())
        np.testing.assert_allclose(dense, [[0.0, 5.0], [5.0, 0.0]])

    def test_davidson_on_ell(self):
        op = generate_sparse_diagonal_dominant(400, 9, sparsity=1e-3, seed=3)
        res = fdt.eigensolve(op, 4, tolerance=1e-8)
        res.block_until_ready()
        assert bool(res.converged)
        dense = np.asarray(op.to_dense())
        expected = scipy.linalg.eigh(dense, eigvals_only=True)[:4]
        np.testing.assert_allclose(np.asarray(res.eigenvalues), expected,
                                   atol=1e-8)


class TestBSR:
    def test_roundtrip_matches_dense(self, rng):
        nbr, bs = 6, 8
        n = nbr * bs
        dense = np.asarray(generate_diagonal_dominant(n, 1e-2))
        op = BSROperator.from_dense(dense, bs)
        np.testing.assert_allclose(np.asarray(op.to_dense()), dense, atol=1e-12)
        np.testing.assert_allclose(np.asarray(op.diagonal()),
                                   np.diagonal(dense), atol=1e-12)

    def test_matmat_matches_dense(self, rng):
        op = generate_banded_bsr(10, 8, bandwidth=2, seed=1)
        n = op.shape[0]
        X = rng.standard_normal((n, 5))
        expected = np.asarray(op.to_dense()) @ X
        np.testing.assert_allclose(np.asarray(op.matmat(jnp.asarray(X))),
                                   expected, atol=1e-10)

    def test_banded_structure(self):
        op = generate_banded_bsr(12, 4, bandwidth=1, seed=0)
        dense = np.asarray(op.to_dense())
        np.testing.assert_allclose(dense, dense.T, atol=1e-14)
        # Outside the block band everything is zero.
        t = dense.reshape(12, 4, 12, 4)
        for i in range(12):
            for j in range(12):
                if abs(i - j) > 1:
                    assert np.all(t[i, :, j, :] == 0)

    def test_davidson_on_bsr(self):
        op = generate_banded_bsr(32, 8, bandwidth=2, coupling=1e-3, seed=5)
        res = fdt.eigensolve(op, 3, tolerance=1e-8)
        res.block_until_ready()
        assert bool(res.converged)
        dense = np.asarray(op.to_dense())
        expected = scipy.linalg.eigh(dense, eigvals_only=True)[:3]
        np.testing.assert_allclose(np.asarray(res.eigenvalues), expected,
                                   atol=1e-8)


class TestPallasBSR:
    """The Triton-route kernel under the Pallas interpreter on CPU."""

    @pytest.mark.parametrize("nbr,bw", [(16, 2), (24, 1), (32, 7)])
    def test_banded_kernel_matches_xla(self, rng, nbr, bw):
        # bf16 storage (the kernel takes bf16 and int8 blocks): same
        # products as the XLA apply, other summation order.
        op = generate_banded_bsr(nbr, 32, bandwidth=bw, seed=9,
                                 dtype=jnp.float32).astype(jnp.bfloat16)
        assert op.bandwidth == bw
        n = op.shape[0]
        X = jnp.asarray(rng.standard_normal((n, 16)), jnp.float32)
        ref = op.matmat(X)
        out = banded_spmm(op.blocks, X, bandwidth=bw, interpret=True,
                          out_dtype=jnp.float32)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   rtol=2e-5, atol=2e-5)

    def test_unsupported_band_shape_falls_back(self, rng):
        # Block size 8 is below the kernel's 32 minimum: the kernel
        # refuses it, and the operator-level kernel backend routes to the
        # plain XLA path and stays correct.
        from fortran_davidson_tpu.ops.pallas_kernels import kernel_supported
        op = generate_banded_bsr(17, 8, bandwidth=2, seed=9,
                                 dtype=jnp.float32)
        assert not kernel_supported(8, 5, 2, jnp.float32)
        with pytest.raises(OperatorError):
            banded_spmm(op.blocks, jnp.zeros((op.shape[0], 8), jnp.float32),
                        bandwidth=2, interpret=True)
        p = op.with_backend("pallas-interpret")
        X = jnp.asarray(rng.standard_normal((op.shape[0], 8)), jnp.float32)
        np.testing.assert_allclose(np.asarray(p.matmat(X)),
                                   np.asarray(op.matmat(X)),
                                   rtol=2e-5, atol=2e-5)

    def test_banded_bf16_accumulate_f32(self, rng):
        op = generate_banded_bsr(16, 32, bandwidth=1, seed=10,
                                 dtype=jnp.float32)
        n = op.shape[0]
        X = jnp.asarray(rng.standard_normal((n, 8)), jnp.float32)
        ref = np.asarray(op.matmat(X))
        out = banded_spmm(op.blocks.astype(jnp.bfloat16), X, bandwidth=1,
                          interpret=True, out_dtype=jnp.float32)
        assert out.dtype == jnp.float32
        np.testing.assert_allclose(np.asarray(out), ref,
                                   rtol=2e-2, atol=2e-2)

    def test_backend_switch(self, rng):
        op = generate_banded_bsr(4, 32, seed=7,
                                 dtype=jnp.float32).astype(jnp.bfloat16)
        p = op.with_backend("pallas-interpret")
        X = jnp.asarray(rng.standard_normal((op.shape[0], 4)), jnp.float32)
        np.testing.assert_allclose(np.asarray(p.matmat(X)),
                                   np.asarray(op.matmat(X)),
                                   rtol=2e-5, atol=2e-5)


class TestMixedPrecision:
    """bf16-stored operators driving f32 solver iterates."""

    def test_bf16_blocks_f32_solve(self):
        import fortran_davidson_tpu as fdt
        # diag values < 256 are exact in bf16, so only the tiny coupling
        # carries representation error.
        op32 = generate_banded_bsr(16, 8, bandwidth=1, coupling=1e-3,
                                   seed=12, dtype=jnp.float32)
        op16 = op32.astype(jnp.bfloat16)
        X = jnp.ones((op32.shape[0], 4), jnp.float32)
        out = op16.matmat(X)
        assert out.dtype == jnp.float32
        ref = fdt.eigensolve(op32, 3, tolerance=1e-4, dtype="float32")
        res = fdt.eigensolve(op16, 3, tolerance=1e-2, dtype="float32")
        res.block_until_ready()
        assert bool(res.converged)
        np.testing.assert_allclose(np.asarray(res.eigenvalues),
                                   np.asarray(ref.eigenvalues), atol=1e-2)

    def test_bf16_pallas_path(self, rng):
        op = generate_banded_bsr(16, 32, bandwidth=1, coupling=1e-3,
                                 seed=13, dtype=jnp.float32)
        p16 = op.astype(jnp.bfloat16).with_backend("pallas-interpret")
        X = jnp.asarray(rng.standard_normal((op.shape[0], 8)), jnp.float32)
        out = p16.matmat(X)
        assert out.dtype == jnp.float32
        np.testing.assert_allclose(np.asarray(out), np.asarray(op.matmat(X)),
                                   rtol=3e-2, atol=3e-2)

"""Sliced-ELL (SELL-σ) remainder format.

The padded :class:`ELLOperator` gathers ``n * L_max`` slots per SpMM;
every padded slot costs real gather time. :class:`SlicedELLOperator`
sorts rows by stored count into power-of-two-width buckets so traffic scales with actual
nnz — the round-3 answer to the unstructured-remainder tail (the
reference's only large-operator story is the on-the-fly dense row loop,
``src/davidson.f90:559-567``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fortran_davidson_tpu import eigensolve
from fortran_davidson_tpu.ops.sparse import (
    ELLOperator, SlicedELLOperator, generate_local_sparse,
    split_band_remainder)
from fortran_davidson_tpu.utils.errors import OperatorError


@pytest.fixture
def skewed_coo():
    """A skewed pattern: most rows have 0-2 stray entries, a few have
    many — the shape of a post-band-split remainder."""
    rng = np.random.default_rng(11)
    n = 400
    rows, cols, vals = [], [], []
    for r in range(n):
        k = 0 if r % 4 else rng.integers(1, 4)
        if r < 6:
            k = 20 + int(r)          # a handful of heavy rows
        cs = rng.choice(n, size=k, replace=False)
        for c in cs:
            rows += [r, c]
            cols += [c, r]
            v = rng.standard_normal()
            vals += [v, v]
    for r in range(n):               # diagonal dominance
        rows.append(r)
        cols.append(r)
        vals.append(50.0 + r)
    return np.array(rows), np.array(cols), np.array(vals), n


class TestSlicedELL:
    def test_matches_ell_spmm(self, skewed_coo):
        rows, cols, vals, n = skewed_coo
        ell = ELLOperator.from_coo(rows, cols, vals, n)
        sell = SlicedELLOperator.from_coo(rows, cols, vals, n)
        x = jnp.asarray(np.random.default_rng(0).standard_normal((n, 7)))
        np.testing.assert_allclose(np.asarray(sell.matmat(x)),
                                   np.asarray(ell.matmat(x)),
                                   rtol=1e-12, atol=1e-12)

    def test_traffic_reduction(self, skewed_coo):
        rows, cols, vals, n = skewed_coo
        ell = ELLOperator.from_coo(rows, cols, vals, n)
        sell = SlicedELLOperator.from_coo(rows, cols, vals, n)
        ell_slots = n * ell.nnz_per_row
        # The skewed fixture's L_max is set by the heavy rows; the
        # sliced layout must beat uniform padding by a wide margin.
        assert sell.gather_slots < ell_slots / 3
        # And stay within 2x + unsort-gather of the true nnz.
        nnz = sum(int(np.count_nonzero(np.asarray(v)))
                  for v in sell.bucket_values)
        assert sell.gather_slots <= 2 * nnz + n + sum(
            int(r.shape[0]) for r in sell.bucket_rows)

    def test_diagonal_offdiag_to_dense(self, skewed_coo):
        rows, cols, vals, n = skewed_coo
        ell = ELLOperator.from_coo(rows, cols, vals, n)
        sell = SlicedELLOperator.from_coo(rows, cols, vals, n)
        np.testing.assert_allclose(np.asarray(sell.diagonal()),
                                   np.asarray(ell.diagonal()), atol=1e-12)
        np.testing.assert_allclose(np.asarray(sell.to_dense()),
                                   np.asarray(ell.to_dense()), atol=1e-12)
        od = sell.offdiag()
        np.testing.assert_allclose(np.asarray(od.to_dense()),
                                   np.asarray(ell.offdiag().to_dense()),
                                   atol=1e-12)
        # offdiag preserves bucket structure (no re-slicing).
        assert od.gather_slots == sell.gather_slots

    def test_from_ell_roundtrip(self, skewed_coo):
        rows, cols, vals, n = skewed_coo
        ell = ELLOperator.from_coo(rows, cols, vals, n)
        sell = SlicedELLOperator.from_ell(ell)
        np.testing.assert_allclose(np.asarray(sell.to_dense()),
                                   np.asarray(ell.to_dense()), atol=1e-12)

    def test_empty_and_zero_rows(self):
        sell = SlicedELLOperator.from_coo([], [], [], 8)
        x = jnp.ones((8, 3))
        assert sell.shape == (8, 8)
        np.testing.assert_array_equal(np.asarray(sell.matmat(x)), 0.0)
        np.testing.assert_array_equal(np.asarray(sell.diagonal()), 0.0)

    def test_jit_and_pytree(self, skewed_coo):
        rows, cols, vals, n = skewed_coo
        sell = SlicedELLOperator.from_coo(rows, cols, vals, n)
        x = jnp.asarray(np.random.default_rng(1).standard_normal((n, 3)))
        y = jax.jit(lambda op, b: op.matmat(b))(sell, x)
        np.testing.assert_allclose(np.asarray(y),
                                   np.asarray(sell.matmat(x)), atol=1e-12)

    def test_out_of_range_raises(self):
        with pytest.raises(OperatorError):
            SlicedELLOperator.from_coo([0, 5], [1, 1], [1.0, 2.0], 4)

    def test_eigensolve_through_sell(self, skewed_coo):
        rows, cols, vals, n = skewed_coo
        sell = SlicedELLOperator.from_coo(rows, cols, vals, n)
        res = eigensolve(sell, 3, tolerance=1e-9)
        dense = np.asarray(sell.to_dense())
        ref = np.linalg.eigvalsh(dense)[:3]
        assert res.converged
        np.testing.assert_allclose(np.asarray(res.eigenvalues), ref,
                                   atol=1e-8)


class TestHybridRemainderFormat:
    def _coo(self):
        rows, cols, vals = generate_local_sparse(600, 9, locality=40.0,
                                                 seed=5)
        return rows, cols, vals, 600

    def test_sell_default_matches_ell(self):
        rows, cols, vals, n = self._coo()
        h_sell = split_band_remainder(rows, cols, vals, n, block_size=32,
                                      bandwidth=1)
        h_ell = split_band_remainder(rows, cols, vals, n, block_size=32,
                                     bandwidth=1, remainder_format="ell")
        assert isinstance(h_sell.remainder, SlicedELLOperator)
        assert isinstance(h_ell.remainder, ELLOperator)
        x = jnp.asarray(np.random.default_rng(2).standard_normal(
            (h_sell.shape[0], 5)))
        np.testing.assert_allclose(np.asarray(h_sell.matmat(x)),
                                   np.asarray(h_ell.matmat(x)),
                                   rtol=1e-12, atol=1e-10)
        assert abs(h_sell.band_fraction - h_ell.band_fraction) < 1e-12

    def test_solve_iteration_parity_across_formats(self):
        rows, cols, vals, n = self._coo()
        res = {}
        for fmt in ("sell", "ell"):
            h = split_band_remainder(rows, cols, vals, n, block_size=32,
                                     bandwidth=1, remainder_format=fmt)
            res[fmt] = eigensolve(h, 2, tolerance=1e-9)
        assert res["sell"].converged and res["ell"].converged
        assert int(res["sell"].iterations) == int(res["ell"].iterations)
        np.testing.assert_allclose(np.asarray(res["sell"].eigenvalues),
                                   np.asarray(res["ell"].eigenvalues),
                                   atol=1e-9)

    def test_shard_converts_to_uniform_ell(self, ):
        # The sliced layout's unsort gather crosses shards; sharding
        # converts to the row-partitionable uniform ELL table.
        from fortran_davidson_tpu.parallel.mesh import default_mesh
        from fortran_davidson_tpu.parallel.sharded import shard_operator
        rows, cols, vals = generate_local_sparse(512, 5, locality=30.0,
                                                 seed=9)
        sell = SlicedELLOperator.from_coo(rows, cols, vals, 512)
        mesh = default_mesh(8)
        sharded = shard_operator(sell, mesh, "rows")
        assert isinstance(sharded, ELLOperator)
        x = jnp.asarray(np.random.default_rng(3).standard_normal((512, 4)))
        np.testing.assert_allclose(np.asarray(sharded.matmat(x)),
                                   np.asarray(sell.matmat(x)),
                                   rtol=1e-12, atol=1e-12)

    def test_unknown_format_raises(self):
        rows, cols, vals, n = self._coo()
        with pytest.raises(OperatorError):
            split_band_remainder(rows, cols, vals, n,
                                 remainder_format="csr")

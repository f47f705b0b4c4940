"""Band + remainder hybrid operator (stream the band, gather the rest).

Splits locality-bearing sparse matrices into a DIA banded part (fast
streaming kernel) plus a small ELL remainder (gather path). Oracle:
the unsplit ELL operator / dense ground truth.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg

import fortran_davidson_tpu as fdt
from fortran_davidson_tpu.ops import pallas_kernels as pk
from fortran_davidson_tpu.ops import sparse
from fortran_davidson_tpu.ops.sparse import (ELLOperator,
                                             HybridBandedOperator,
                                             generate_local_sparse,
                                             split_band_remainder)


@pytest.fixture(scope="module")
def local_coo():
    return generate_local_sparse(600, 12, locality=30.0, seed=7)


class TestSplit:
    def test_matches_unsplit(self, local_coo, rng):
        rows, cols, vals = local_coo
        n = 600
        hyb = split_band_remainder(rows, cols, vals, n, block_size=64,
                                   bandwidth=1)
        n_pad = hyb.shape[0]
        assert n_pad % 64 == 0 and n_pad >= n
        full = ELLOperator.from_coo(rows, cols, vals, n)
        X = rng.standard_normal((n_pad, 5))
        got = np.asarray(hyb.matmat(jnp.asarray(X)))
        expected = np.zeros((n_pad, 5))
        expected[:n] = np.asarray(full.matmat(jnp.asarray(X[:n])))
        # Diagonal tail padding: above-spectrum scalar (sorts last in a
        # lowest-k solve), uniform across the padded rows.
        pad_val = np.asarray(hyb.diagonal())[n]
        assert pad_val > np.abs(vals).max()
        expected[n:] = pad_val * X[n:]
        np.testing.assert_allclose(got, expected, atol=1e-9)

    def test_band_captures_local_mass(self, local_coo):
        rows, cols, vals = local_coo
        hyb = split_band_remainder(rows, cols, vals, 600, block_size=64,
                                   bandwidth=1)
        # locality 30 << block span 64: nearly everything lands in-band.
        assert hyb.band_fraction > 0.9

    def test_diagonal(self, local_coo):
        rows, cols, vals = local_coo
        hyb = split_band_remainder(rows, cols, vals, 600, block_size=64,
                                   bandwidth=1)
        d = np.asarray(hyb.diagonal())
        np.testing.assert_allclose(d[:600], np.arange(1, 601), atol=1e-12)
        # Auto padding sits strictly above the Gershgorin bound ||A||_inf.
        row_abs = np.zeros(600)
        np.add.at(row_abs, rows, np.abs(vals))
        assert (d[600:] > row_abs.max()).all()
        np.testing.assert_allclose(d[600:], d[600], atol=1e-12)
        # Explicit override (e.g. for use as the B of a pencil).
        hyb_b = split_band_remainder(rows, cols, vals, 600, block_size=64,
                                     bandwidth=1, pad_diag=1.0)
        np.testing.assert_allclose(np.asarray(hyb_b.diagonal())[600:], 1.0,
                                   atol=1e-12)

    def test_davidson_on_hybrid(self, local_coo):
        rows, cols, vals = local_coo
        hyb = split_band_remainder(rows, cols, vals, 600, block_size=64,
                                   bandwidth=1)
        res = fdt.eigensolve(hyb, 4, tolerance=1e-8)
        res.block_until_ready()
        assert bool(res.converged)
        dense = np.asarray(hyb.to_dense())
        expected = scipy.linalg.eigh(dense, eigvals_only=True)[:4]
        np.testing.assert_allclose(np.asarray(res.eigenvalues), expected,
                                   atol=1e-8)

    def test_padding_never_displaces_true_eigenpairs(self):
        # Regression (ADVICE r1): padding the diagonal tail at 1.0 would
        # inject spurious eigenvalues at 1.0 — inside the spectrum of any
        # operator whose lowest-k reaches 1 (diag = 1..n fixtures!) — and
        # a lowest-k solve would return the padding's pairs instead of the
        # user's matrix's. The oracle here is the ORIGINAL n x n matrix.
        n = 530  # deliberately not a multiple of block_size: 110 pad rows
        rows, cols, vals = generate_local_sparse(n, 10, locality=20.0,
                                                 seed=11)
        hyb = split_band_remainder(rows, cols, vals, n, block_size=64,
                                   bandwidth=1)
        assert hyb.shape[0] > n
        res = fdt.eigensolve(hyb, 4, tolerance=1e-8)
        assert bool(res.converged)
        dense = np.zeros((n, n))
        np.add.at(dense, (rows, cols), vals)  # duplicates sum, like from_coo
        expected = scipy.linalg.eigh(dense, eigvals_only=True)[:4]
        np.testing.assert_allclose(np.asarray(res.eigenvalues), expected,
                                   atol=1e-8)
        # Eigenvectors live in the original rows; padded rows carry ~0.
        evecs = np.asarray(res.eigenvectors)
        assert np.abs(evecs[n:]).max() < 1e-8

    def test_pallas_backend_switch(self, local_coo, rng, monkeypatch):
        # bf16 band blocks at bs = 32: a shape the kernel takes, so the
        # interpret-mode kernel (not XLA) applies the band.
        rows, cols, vals = local_coo
        hyb = split_band_remainder(rows, cols, vals, 600, block_size=32,
                                   bandwidth=2, dtype=jnp.float32)
        hyb = HybridBandedOperator(hyb.band.astype(jnp.bfloat16),
                                   hyb.remainder)
        p = hyb.with_backend("pallas-interpret")
        calls = []
        monkeypatch.setattr(sparse, "banded_spmm",
                            lambda *a, **kw: calls.append(kw)
                            or pk.banded_spmm(*a, **kw))
        X = jnp.asarray(rng.standard_normal((hyb.shape[0], 4)), jnp.float32)
        got = np.asarray(p.matmat(X))
        assert [kw["interpret"] for kw in calls] == [True]
        np.testing.assert_allclose(got, np.asarray(hyb.matmat(X)),
                                   rtol=3e-5, atol=3e-5)
        assert len(calls) == 1        # the XLA apply took no kernel

    def test_pure_band_has_no_remainder(self):
        rows, cols, vals = generate_local_sparse(640, 4, locality=2.0,
                                                 seed=3)
        # bandwidth 2 blocks of 64 rows: distance~2 geometric entries all
        # land in-band.
        hyb = split_band_remainder(rows, cols, vals, 640, block_size=64,
                                   bandwidth=2)
        assert hyb.remainder is None

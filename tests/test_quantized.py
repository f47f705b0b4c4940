"""int8-quantized banded operator: kernel parity, accuracy contract,
and end-to-end solves at bf16-class tolerances.

The quantized path is the opt-in HBM-bandwidth saver for the hot SpMM
(blocks at 1 byte instead of 2/4); the exact-diagonal split is what keeps
it usable for diagonal-dominant operators (reference fixture semantics:
diag = 1..n, off-diag ~ coupling, ``src/array_utils.f90:86-113``).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from fortran_davidson_tpu.ops.sparse import (BSROperator,
                                             QuantizedBandedOperator,
                                             generate_banded_bsr,
                                             quantize_banded_int8)


def _quant_tol(op):
    """Expected matmat error bound: per-slot int8 quantization error is
    <= scale/2 per entry; a row sums K*bs of them against unit-scale x."""
    nbr, bs, kbs = op.qblocks.shape
    return 0.5 * float(jnp.max(op.scale_rows)) * kbs


class TestQuantizeBandedInt8:
    @pytest.fixture
    def base(self):
        return generate_banded_bsr(32, 8, bandwidth=2, coupling=1e-3,
                                   dtype=jnp.float32)

    def test_structure(self, base):
        q = quantize_banded_int8(base)
        nbr, bs, kbs = base.blocks.shape
        assert q.qblocks.shape == (nbr, bs, kbs)
        assert q.qblocks.dtype == jnp.int8
        assert q.scale_rows.shape == (nbr, kbs)
        assert q.diag.shape == (nbr, bs)
        assert q.shape == base.shape

    def test_diagonal_exact(self, base):
        q = quantize_banded_int8(base)
        np.testing.assert_array_equal(np.asarray(q.diagonal()),
                                      np.asarray(base.diagonal(),
                                                 np.float32))

    def test_offdiag_zeroes_diag_only(self, base):
        q = quantize_banded_int8(base)
        off = q.offdiag()
        assert float(jnp.abs(off.diagonal()).max()) == 0.0
        # Off-diagonal application unchanged.
        x = jnp.ones((base.shape[0], 4), jnp.float32)
        np.testing.assert_allclose(
            np.asarray(q.matmat(x) - off.matmat(x)),
            np.asarray(q.diagonal())[:, None] * np.asarray(x), rtol=1e-6)

    def test_matmat_xla_close_to_exact(self, base):
        q = quantize_banded_int8(base)  # backend inherits "xla"
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.standard_normal((base.shape[0], 8)),
                        jnp.float32)
        exact = np.asarray(base.matmat(x))
        approx = np.asarray(q.matmat(x))
        assert np.abs(approx - exact).max() < _quant_tol(q) * 8

    def test_pallas_interpret_matches_xla_fallback(self):
        # Shape the kernel supports (power-of-two block size >= 32): the
        # interpret-mode kernel must agree with the plain DIA slot-sum to
        # f32 roundoff (same products, other summation order).
        base = generate_banded_bsr(16, 32, bandwidth=1, coupling=1e-3,
                                   dtype=jnp.float32)
        q = quantize_banded_int8(base)
        rng = np.random.default_rng(1)
        x = jnp.asarray(rng.standard_normal((base.shape[0], 4)),
                        jnp.float32)
        got = np.asarray(q.with_backend("pallas-interpret").matmat(x))
        want = np.asarray(q.with_backend("xla").matmat(x))
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)

    def test_requires_banded_storage(self):
        dense = np.diag(np.arange(1.0, 17.0))
        op = BSROperator.from_dense(dense, bs=4)  # no bandwidth declared
        with pytest.raises(Exception):
            quantize_banded_int8(op)

    def test_eigensolve_bf16_class_tolerance(self):
        import fortran_davidson_tpu as fdt
        base = generate_banded_bsr(32, 8, bandwidth=1, coupling=1e-3,
                                   dtype=jnp.float32)
        q = quantize_banded_int8(base)
        exact = fdt.eigensolve(base, 3, tolerance=1e-6, dtype="float32",
                               relative_tolerance=True, max_iterations=100)
        approx = fdt.eigensolve(q, 3, tolerance=1e-3, dtype="float32",
                                relative_tolerance=True, max_iterations=100)
        assert bool(approx.converged)
        # Eigenvalues agree to the quantization error of the OPERATOR
        # (perturbation bound: |dlam| <= ||dA||).
        np.testing.assert_allclose(np.asarray(approx.eigenvalues),
                                   np.asarray(exact.eigenvalues),
                                   atol=2 * _quant_tol(q))

    def test_sharded_halo_quantized(self):
        # shard_operator routes quantized -> HaloQuantizedOperator (int8
        # blocks + scales + diagonal row-sharded, ppermute halos); both
        # local backends must match the single-device operator, and the
        # sharded solve must match single-device iteration counts.
        import fortran_davidson_tpu as fdt
        from fortran_davidson_tpu.parallel import (HaloQuantizedOperator,
                                                   default_mesh,
                                                   eigensolve_sharded,
                                                   shard_operator)
        mesh = default_mesh()
        base = generate_banded_bsr(32, 8, bandwidth=1, coupling=1e-3,
                                   dtype=jnp.float32)
        q = quantize_banded_int8(base)
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.standard_normal((base.shape[0], 4)),
                        jnp.float32)
        hq = shard_operator(q, mesh)
        assert isinstance(hq, HaloQuantizedOperator)
        np.testing.assert_allclose(np.asarray(hq.matmat(x)),
                                   np.asarray(q.matmat(x)),
                                   rtol=2e-5, atol=2e-5)
        hp = HaloQuantizedOperator.from_quantized(q, mesh,
                                                  backend="pallas-interpret")
        np.testing.assert_allclose(np.asarray(hp.matmat(x)),
                                   np.asarray(q.matmat(x)),
                                   rtol=2e-5, atol=2e-5)
        common = dict(tolerance=1e-3, dtype="float32",
                      relative_tolerance=True)
        single = fdt.eigensolve(q, 3, **common)
        sh = eigensolve_sharded(q, 3, mesh, **common)
        assert int(sh.iterations) == int(single.iterations)
        np.testing.assert_allclose(np.asarray(sh.eigenvalues),
                                   np.asarray(single.eigenvalues),
                                   rtol=1e-5)

    def test_halo_offdiag_exact(self):
        from fortran_davidson_tpu.parallel import (HaloQuantizedOperator,
                                                   default_mesh)
        mesh = default_mesh()
        base = generate_banded_bsr(16, 8, bandwidth=1, coupling=1e-3,
                                   dtype=jnp.float32)
        q = quantize_banded_int8(base)
        hq = HaloQuantizedOperator.from_quantized(q, mesh)
        off = hq.offdiag()
        assert float(jnp.abs(off.diagonal()).max()) == 0.0
        x = jnp.ones((base.shape[0], 2), jnp.float32)
        np.testing.assert_allclose(
            np.asarray(hq.matmat(x) - off.matmat(x)),
            np.asarray(hq.diagonal())[:, None] * np.asarray(x),
            rtol=1e-6, atol=1e-6)

    def test_refined_path_composes(self):
        # offdiag() is exact for the quantized operator, so the refined
        # (double-single) pipeline runs on quantized storage unchanged —
        # it converges to the QUANTIZED operator's spectrum.
        import scipy.linalg
        import fortran_davidson_tpu as fdt
        base = generate_banded_bsr(16, 8, bandwidth=1, coupling=1e-3,
                                   dtype=jnp.float32)
        q = quantize_banded_int8(base)
        res = fdt.eigensolve(q, 2, tolerance=1e-5, dtype="float32",
                             refined=True, relative_tolerance=True,
                             max_iterations=100)
        assert bool(res.converged)
        want = scipy.linalg.eigh(np.asarray(q.to_dense(), np.float64),
                                 eigvals_only=True)[:2]
        np.testing.assert_allclose(np.asarray(res.eigenvalues), want,
                                   atol=1e-4)


class TestQuantizedRefined:
    def test_refined_polish_on_quantized(self):
        # The refined path's off-diagonal split must exist for the int8
        # operator and its TRUE residuals are measured against the
        # QUANTIZED operator (the one actually being solved).
        import jax.numpy as jnp

        from fortran_davidson_tpu.ops.sparse import (generate_banded_bsr,
                                                     quantize_banded_int8)
        bsr = generate_banded_bsr(64, 16, bandwidth=1, coupling=1e-3,
                                  dtype=jnp.float32)
        q = quantize_banded_int8(bsr)
        import fortran_davidson_tpu as fdt
        r = fdt.eigensolve(q, 3, tolerance=1e-5, dtype="float32",
                           refined=True, final_polish=2,
                           max_iterations=200)
        assert bool(r.converged)
        assert float(np.max(np.asarray(r.residual_norms))) < 1e-8


def test_host_quantized_generator_bit_identical():
    """generate_banded_bsr_quantized (host-side numpy, for beyond-HBM
    scales) must match quantize_banded_int8(generate_banded_bsr(...))
    bit-for-bit: same assembly, same quantization math."""
    import numpy as np

    from fortran_davidson_tpu.ops.sparse import (
        generate_banded_bsr, generate_banded_bsr_quantized,
        quantize_banded_int8)

    for bw, seed in ((1, 0), (2, 7)):
        dev = quantize_banded_int8(
            generate_banded_bsr(12, 8, bandwidth=bw, coupling=1e-3,
                                seed=seed, dtype=jnp.float32))
        host = generate_banded_bsr_quantized(12, 8, bandwidth=bw,
                                             coupling=1e-3, seed=seed)
        np.testing.assert_array_equal(np.asarray(dev.qblocks),
                                      np.asarray(host.qblocks))
        np.testing.assert_array_equal(np.asarray(dev.scale_rows),
                                      np.asarray(host.scale_rows))
        np.testing.assert_array_equal(np.asarray(dev.diag),
                                      np.asarray(host.diag))

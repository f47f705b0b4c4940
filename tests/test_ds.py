"""Double-single compensated arithmetic vs an f64 oracle (CPU x64).

These are the numerics that let the f32 solver reach the
reference's real64 accuracy (``/root/reference/src/numeric_kinds.f90:10``):
each primitive is checked for exactness, each reduction for beating the
naive f32 error by orders of magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from fortran_davidson_tpu.utils import ds


def f32(x):
    return jnp.asarray(np.asarray(x), jnp.float32)


class TestErrorFreeTransforms:
    def test_two_sum_exact(self, rng):
        a = f32(rng.standard_normal(1000) * 1e6)
        b = f32(rng.standard_normal(1000) * 1e-3)
        s, e = ds.two_sum(a, b)
        exact = np.asarray(a, np.float64) + np.asarray(b, np.float64)
        got = np.asarray(s, np.float64) + np.asarray(e, np.float64)
        np.testing.assert_array_equal(got, exact)

    def test_two_prod_exact(self, rng):
        a = f32(rng.standard_normal(1000) * 37.0)
        b = f32(rng.standard_normal(1000) * 0.013)
        p, e = ds.two_prod(a, b)
        exact = np.asarray(a, np.float64) * np.asarray(b, np.float64)
        got = np.asarray(p, np.float64) + np.asarray(e, np.float64)
        # f32 two-prod is exact: p+e == a*b in f64 (products of 24-bit
        # mantissas fit in 48 bits < 53).
        np.testing.assert_array_equal(got, exact)


class TestDsArithmetic:
    def test_add_mul_div_sqrt(self, rng):
        a64 = rng.standard_normal(512) * 1e3
        b64 = np.abs(rng.standard_normal(512)) + 0.5
        a = ds.ds(f32(a64))
        b = ds.ds(f32(b64))
        a64 = np.asarray(a.hi, np.float64)
        b64 = np.asarray(b.hi, np.float64)

        def err(got, exact):
            scale = np.maximum(np.abs(exact), 1e-30)
            return np.max(np.abs(
                (np.asarray(got.hi, np.float64)
                 + np.asarray(got.lo, np.float64)) - exact) / scale)

        assert err(ds.ds_add(a, b), a64 + b64) < 1e-13
        assert err(ds.ds_mul(a, b), a64 * b64) < 1e-13
        assert err(ds.ds_div(a, b), a64 / b64) < 1e-13
        assert err(ds.ds_sqrt(b), np.sqrt(b64)) < 1e-13

    def test_sqrt_of_zero(self):
        out = ds.ds_sqrt(ds.ds(f32([0.0, 4.0])))
        np.testing.assert_array_equal(np.asarray(out.to_float()), [0.0, 2.0])


class TestCompensatedReductions:
    def test_sum_tree_vs_f64(self, rng):
        # Adversarial: large cancellations across the summed axis.
        x64 = rng.standard_normal(4096) * np.logspace(0, 6, 4096)
        x = f32(x64)
        exact = np.sum(np.asarray(x, np.float64))
        got = ds.ds_sum_tree(x)
        got64 = float(np.asarray(got.hi, np.float64)) + float(
            np.asarray(got.lo, np.float64))
        naive = float(jnp.sum(x))
        scale = np.sum(np.abs(np.asarray(x, np.float64)))
        assert abs(got64 - exact) / scale < 1e-12
        assert abs(got64 - exact) <= abs(naive - exact) + 1e-30

    @pytest.mark.parametrize("n", [2**14, 2**17])
    def test_gram_beats_naive(self, rng, n):
        m = 6
        V64 = rng.standard_normal((n, m))
        V64 /= np.linalg.norm(V64, axis=0)
        V = f32(V64)
        V64 = np.asarray(V, np.float64)
        exact = V64.T @ V64
        naive = np.asarray(
            jnp.dot(V, V, precision="highest").T @ V
            if False else V.T @ V, np.float64)
        got = ds.gram_ds(V, chunk=1024)
        got64 = np.asarray(got.hi, np.float64) + np.asarray(got.lo,
                                                            np.float64)
        err_got = np.abs(got64 - exact).max()
        err_naive = np.abs(naive - exact).max()
        # Compensated Gram must be orders of magnitude tighter than f32.
        assert err_got < 3e-7 * 1024 / np.sqrt(n) + 1e-9
        assert err_got < err_naive / 5 + 1e-12

    def test_col_norms(self, rng):
        n = 2**15
        X64 = rng.standard_normal((n, 4)) * 3.0
        X = f32(X64)
        X64 = np.asarray(X, np.float64)
        exact = np.linalg.norm(X64, axis=0)
        got = np.asarray(ds.col_norms_ds(X, chunk=1024), np.float64)
        np.testing.assert_allclose(got, exact, rtol=2e-7)

    def test_dot_cols(self, rng):
        n = 2**14
        X = f32(rng.standard_normal((n, 3)))
        Y = f32(rng.standard_normal((n, 3)))
        X64 = np.asarray(X, np.float64)
        Y64 = np.asarray(Y, np.float64)
        exact = np.sum(X64 * Y64, axis=0)
        got = ds.dot_cols_ds(X, Y)
        got64 = np.asarray(got.hi, np.float64) + np.asarray(got.lo,
                                                            np.float64)
        # Dot2 quality: error ~ n * eps^2 * sum|x_i y_i| even under the
        # cancellation of a zero-mean random dot.
        scale = np.sum(np.abs(X64 * Y64), axis=0).max()
        np.testing.assert_allclose(got64, exact, atol=scale * 1e-10)

    def test_chunk_adapts_to_n(self, rng):
        # n not divisible by the default chunk: must still be correct.
        n = 3 * 5 * 7 * 64
        X = f32(rng.standard_normal((n, 2)))
        X64 = np.asarray(X, np.float64)
        got = ds.gram_ds(X)
        got64 = np.asarray(got.hi, np.float64) + np.asarray(got.lo,
                                                            np.float64)
        np.testing.assert_allclose(got64, X64.T @ X64, atol=1e-7)


class TestShiftedDiagApply:
    def test_cancellation_region(self, rng):
        # diag ~ 1e6 with shift equal to one of the entries: the f32
        # product (d - s) * x loses ~eps*|d| ~ 0.06 absolute; the DS
        # version must keep the error near eps^2 * |d|.
        n, k = 4096, 3
        d64 = np.sort(rng.uniform(1.0, 1e6, n))
        d = f32(d64)
        d64 = np.asarray(d, np.float64)
        shift = f32([d64[10], d64[100] * (1 + 3e-8), 2.5])
        X = f32(rng.standard_normal((n, k)))
        X64 = np.asarray(X, np.float64)
        exact = (d64[:, None] - np.asarray(shift, np.float64)[None, :]) * X64
        got = ds.shifted_diag_apply(d, shift, X)
        got64 = np.asarray(got.hi, np.float64) + np.asarray(got.lo,
                                                            np.float64)
        err = np.abs(got64 - exact).max()
        naive = np.asarray((d[:, None] - shift[None, :]) * X, np.float64)
        err_naive = np.abs(naive - exact).max()
        assert err < 1e-6  # ~eps^2 * |d| * |x|
        assert err < err_naive / 100


class TestCascadeStrategy:
    """The streaming slab-cascade reductions (the default hot path: one
    pass, no relayout) must
    match the tree strategy's accuracy class against the f64 oracle,
    including tails (n not a multiple of the slab) and cancellation."""

    # Crosses _CASCADE_MIN_ROWS and exercises a ragged tail slab.
    N = ds._CASCADE_MIN_ROWS + 40_961

    def _xy(self, rng, k=3):
        # Heavy cancellation: pair each entry with its near-negation.
        x = rng.standard_normal((self.N, k))
        y = rng.standard_normal((self.N, k))
        h = self.N // 2
        y[1:2 * h:2] = -y[0:2 * h:2] * (
            1 + 1e-7 * rng.standard_normal((h, k)))
        x[1:2 * h:2] = x[0:2 * h:2]
        return x, y

    def test_dot_cols_cascade_vs_f64(self, rng):
        x, y = self._xy(rng)
        want = np.sum(np.asarray(f32(x), np.float64)
                      * np.asarray(f32(y), np.float64), axis=0)
        with ds.sum_strategy("cascade"):
            got = ds.dot_cols_ds(f32(x), f32(y))
        total = np.asarray(got.hi, np.float64) + np.asarray(got.lo,
                                                            np.float64)
        scale = np.sum(np.abs(np.asarray(f32(x), np.float64)
                              * np.asarray(f32(y), np.float64)), axis=0)
        assert np.all(np.abs(total - want) < 1e-12 * scale)

    def test_strategies_agree(self, rng):
        x, y = self._xy(rng)
        with ds.sum_strategy("cascade"):
            a = ds.dot_cols_ds(f32(x), f32(y))
        with ds.sum_strategy("tree"):
            b = ds.dot_cols_ds(f32(x), f32(y))
        av = np.asarray(a.hi, np.float64) + np.asarray(a.lo, np.float64)
        bv = np.asarray(b.hi, np.float64) + np.asarray(b.lo, np.float64)
        np.testing.assert_allclose(av, bv, rtol=0, atol=1e-10)

    def test_weighted_dot_cols_vs_f64(self, rng):
        k = 4
        x = f32(rng.standard_normal((self.N, k)))
        d = f32(rng.uniform(0.5, 2.0, self.N) * np.arange(1, self.N + 1))
        want = np.sum(np.asarray(d, np.float64)[:, None]
                      * np.asarray(x, np.float64) ** 2, axis=0)
        with ds.sum_strategy("cascade"):
            got = ds.weighted_dot_cols_ds(d, x)
        total = np.asarray(got.hi, np.float64) + np.asarray(got.lo,
                                                            np.float64)
        np.testing.assert_allclose(total, want, rtol=1e-12)
        # naive f32 for comparison must be much worse
        naive = np.sum(np.asarray(d) [:, None]* np.asarray(x) ** 2,
                       axis=0, dtype=np.float32)
        assert (np.max(np.abs(total - want) / want)
                < 1e-4 * max(np.max(np.abs(naive - want) / want), 1e-30)
                or np.max(np.abs(naive - want) / want) < 1e-7)

    def test_col_sumsq_pair_vs_f64(self, rng):
        k = 2
        hi = f32(rng.standard_normal((self.N, k)))
        lo = f32(rng.standard_normal((self.N, k)) * 1e-8)
        want = np.sum((np.asarray(hi, np.float64)
                       + np.asarray(lo, np.float64)) ** 2, axis=0)
        with ds.sum_strategy("cascade"):
            got = ds.col_sumsq_pair_ds(hi, lo)
        total = np.asarray(got.hi, np.float64) + np.asarray(got.lo,
                                                            np.float64)
        # lo^2 term (~1e-16 relative) is deliberately dropped.
        np.testing.assert_allclose(total, want, rtol=1e-12)

    def test_tall_sum_tail_exact(self, rng):
        # All-ones column: the exact sum is N; cascade with a ragged
        # tail must not drop or double-count rows.
        x = jnp.ones((self.N, 1), jnp.float32)
        with ds.sum_strategy("cascade"):
            got = ds.tall_sum_ds(x)
        total = float(np.asarray(got.hi, np.float64)
                      + np.asarray(got.lo, np.float64))
        assert total == float(self.N)

    def test_invalid_strategy_raises(self):
        with pytest.raises(ValueError):
            with ds.sum_strategy("bogus"):
                pass

    @pytest.mark.parametrize("divisor", [1, 2, 4, 8])
    def test_shard_local_fold_accuracy(self, rng, divisor):
        # The shard-local pairing (round 5: tree folds reshape to
        # (D, r/D, ...) so every level is elementwise within a shard)
        # is an error-free transform: any D must stay in the eps²
        # accuracy class vs the f64 oracle.
        n, k = 4096, 3
        x = f32(rng.standard_normal((n, k)) * 10.0 ** rng.integers(
            -3, 4, (n, k)))
        want = np.sum(np.asarray(x, np.float64), axis=0)
        with ds.sum_strategy("tree", row_divisor=divisor):
            got = ds.tall_sum_ds(x)
        total = np.asarray(got.hi, np.float64) + np.asarray(got.lo,
                                                            np.float64)
        scale = np.sum(np.abs(np.asarray(x, np.float64)), axis=0)
        assert np.all(np.abs(total - want) < 1e-12 * scale)

    def test_shard_local_fold_indivisible_rows_fall_back(self, rng):
        # Leading dims not divisible by D take the plain pairing —
        # same accuracy, no crash.
        x = f32(rng.standard_normal((1000, 2)))
        want = np.sum(np.asarray(x, np.float64), axis=0)
        with ds.sum_strategy("tree", row_divisor=7):
            got = ds.tall_sum_ds(x)
        total = np.asarray(got.hi, np.float64) + np.asarray(got.lo,
                                                            np.float64)
        np.testing.assert_allclose(total, want, rtol=0, atol=1e-10)

    def test_gram_chunk_divisor_aware(self):
        # Under a row divisor the Gram chunk must divide the per-shard
        # rows (or the (n/c, c, m) reshape resharded across devices).
        with ds.sum_strategy("tree", row_divisor=8):
            assert (16384 // 8) % ds._chunk(16384, None) == 0
            assert (65536 // 8) % ds._chunk(65536, None) == 0
        assert ds._chunk(16384, None) == 4096  # default restored

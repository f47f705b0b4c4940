"""``matmat_with_gram`` on the banded operators: ``Y = A @ X`` and
``G = Vᵀ Y`` (the Davidson hot pair — apply the operator, project;
reference ``src/davidson.f90:131,159``), composed in two passes, pinned
against the separate products.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fortran_davidson_tpu.ops.sparse import (
    generate_banded_bsr, quantize_banded_int8)


@pytest.fixture
def rng():
    return np.random.default_rng(17)


class TestOperatorAPI:
    def test_bsr_fused_matches_composition(self, rng):
        op = generate_banded_bsr(32, 16, bandwidth=2, seed=13,
                                 dtype=jnp.float32).with_backend(
                                     "pallas-interpret")
        n = op.shape[0]
        x = jnp.asarray(rng.standard_normal((n, 8)), jnp.float32)
        v = jnp.asarray(rng.standard_normal((n, 12)), jnp.float32)
        y, g = op.matmat_with_gram(x, v)
        np.testing.assert_allclose(np.asarray(y), np.asarray(op.matmat(x)),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(
            np.asarray(g),
            np.asarray(v).T @ np.asarray(op.matmat(x)),
            rtol=1e-4, atol=1e-3)
        g_only = op.matmat_with_gram(x, v, write_out=False)
        np.testing.assert_allclose(np.asarray(g_only), np.asarray(g),
                                   rtol=1e-5, atol=1e-5)

    def test_xla_backend_falls_back(self, rng):
        op = generate_banded_bsr(17, 8, bandwidth=2, seed=13,
                                 dtype=jnp.float32)  # unsupported shape
        n = op.shape[0]
        x = jnp.asarray(rng.standard_normal((n, 8)), jnp.float32)
        y, g = op.matmat_with_gram(x)
        np.testing.assert_allclose(np.asarray(y), np.asarray(op.matmat(x)),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(x).T @ np.asarray(op.matmat(x)),
            rtol=1e-4, atol=1e-3)

    def test_quantized_operator_fused(self, rng):
        op = generate_banded_bsr(32, 8, bandwidth=2, seed=19,
                                 dtype=jnp.float32)
        qop = quantize_banded_int8(op)
        n = op.shape[0]
        x = jnp.asarray(rng.standard_normal((n, 8)), jnp.float32)
        y, g = qop.matmat_with_gram(x)
        np.testing.assert_allclose(np.asarray(y), np.asarray(qop.matmat(x)),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(x).T @ np.asarray(qop.matmat(x)),
            rtol=1e-4, atol=1e-2)

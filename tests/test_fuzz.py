"""Randomized configuration sweep (robustness tier).

Random (n, k, method, expansion, subspace, operator-kind, dtype)
combinations must either converge to scipy's answer or report clean
non-convergence — never NaN, never wrong eigenvalues with
``converged=True``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg

import fortran_davidson_tpu as fdt
from fortran_davidson_tpu.models.generators import generate_diagonal_dominant
from fortran_davidson_tpu.ops import pallas_kernels as pk
from fortran_davidson_tpu.ops import sparse
from fortran_davidson_tpu.ops.sparse import (generate_banded_bsr,
                                             quantize_banded_int8)


def _cases():
    rng = np.random.default_rng(99)
    cases = []
    for i in range(12):
        n = int(rng.integers(24, 150))
        k = int(rng.integers(1, min(6, n // 6 + 1)))
        method = rng.choice(["DPR", "GJD"])
        expansion = rng.choice(["doubling", "lowest-k"])
        gen = bool(rng.integers(0, 2))
        max_dim = (None if rng.integers(0, 2)
                   else int(rng.integers(max(2 * k + 1, 5), max(4 * k, 8))))
        cases.append((i, n, k, str(method), str(expansion), gen, max_dim))
    return cases


@pytest.mark.parametrize("seed,n,k,method,expansion,gen,max_dim", _cases())
def test_random_config(seed, n, k, method, expansion, gen, max_dim):
    A = generate_diagonal_dominant(n, 1e-3, key=jax.random.PRNGKey(seed))
    B = (generate_diagonal_dominant(n, 1e-3, diag_val=1.0,
                                    key=jax.random.PRNGKey(seed + 100))
         if gen else None)
    res = fdt.eigensolve(A, k, second_matrix=B, method=method,
                         expansion=expansion, max_dim_sub=max_dim,
                         tolerance=1e-8, max_iterations=300)
    res.block_until_ready()
    vals = np.asarray(res.eigenvalues)
    assert np.all(np.isfinite(vals)), "NaN/Inf eigenvalues"
    if bool(res.converged):
        if gen:
            expected = scipy.linalg.eigh(np.asarray(A), np.asarray(B),
                                         eigvals_only=True)[:k]
        else:
            expected = scipy.linalg.eigh(np.asarray(A),
                                         eigvals_only=True)[:k]
        np.testing.assert_allclose(vals, expected, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_banded_f32(seed, monkeypatch):
    # Odd seeds: int8 blocks at bs >= 32 through the interpret-mode
    # kernel (the shapes it takes); even seeds: f32 blocks through XLA.
    kernel = bool(seed % 2)
    rng = np.random.default_rng(seed)
    nbr = int(rng.integers(2, 8)) * 8
    bs = int(rng.choice([32, 64] if kernel else [8, 16]))
    bw = int(rng.integers(1, 3))
    op = generate_banded_bsr(nbr, bs, bandwidth=bw, coupling=1e-3,
                             seed=seed, dtype=jnp.float32)
    calls = []
    if kernel:
        op = quantize_banded_int8(op).with_backend("pallas-interpret")
        monkeypatch.setattr(sparse, "banded_spmm",
                            lambda *a, **kw: calls.append(kw)
                            or pk.banded_spmm(*a, **kw))
    res = fdt.eigensolve(op, 3, tolerance=1e-4, dtype="float32",
                         max_iterations=100)
    assert bool(calls) == kernel
    assert all(kw["interpret"] for kw in calls)
    res.block_until_ready()
    vals = np.asarray(res.eigenvalues)
    assert np.all(np.isfinite(vals))
    if bool(res.converged):
        expected = scipy.linalg.eigh(
            np.asarray(op.to_dense(), np.float64), eigvals_only=True)[:3]
        np.testing.assert_allclose(vals, expected, atol=1e-3)


def _feature_cases():
    """Random sweeps over the beyond-reference feature surface: refined,
    final_polish, locking, Chebyshev (fixed/auto), OLSEN, plateau/stall
    interplay — same contract: converge to scipy's answer or report
    clean non-convergence/stall, never NaN, never a lie."""
    rng = np.random.default_rng(1234)
    cases = []
    for i in range(10):
        n = int(rng.integers(60, 260))
        k = int(rng.integers(1, 5))
        method = str(rng.choice(["DPR", "OLSEN", "GJD"]))
        refined = bool(rng.integers(0, 2))
        polish = int(rng.integers(0, 3)) if refined else 0
        locking = bool(rng.integers(0, 2))
        cheb = rng.choice([0, 4, "auto"])
        cheb = int(cheb) if cheb != "auto" else "auto"
        dtype = str(rng.choice(["float64", "float32"]))
        expansion = str(rng.choice(["doubling", "lowest-k"]))
        # Generalized pencils join the sweep (refined pencils are
        # first-class); the Chebyshev filter is a polynomial in A alone,
        # so gen forces cheb off (the config validation would raise).
        gen = bool(rng.integers(0, 2))
        if gen:
            cheb = 0
        cases.append((i, n, k, method, refined, polish, locking, cheb,
                      dtype, expansion, gen))
    return cases


@pytest.mark.parametrize(
    "seed,n,k,method,refined,polish,locking,cheb,dtype,expansion,gen",
    _feature_cases())
def test_random_feature_combo(seed, n, k, method, refined, polish,
                              locking, cheb, dtype, expansion, gen):
    A = generate_diagonal_dominant(n, 1e-3, key=jax.random.PRNGKey(seed))
    B = (generate_diagonal_dominant(n, 1e-3, diag_val=1.0,
                                    key=jax.random.PRNGKey(seed + 300))
         if gen else None)
    if dtype == "float32":
        A = jnp.asarray(np.asarray(A), jnp.float32)
        B = None if B is None else jnp.asarray(np.asarray(B), jnp.float32)
    tol = 1e-8 if dtype == "float64" else 1e-5
    res = fdt.eigensolve(A, k, second_matrix=B, method=method,
                         tolerance=tol,
                         max_iterations=400, dtype=dtype,
                         expansion=expansion, refined=refined,
                         final_polish=polish, locking=locking,
                         cheb_degree=cheb)
    res.block_until_ready()
    vals = np.asarray(res.eigenvalues)
    assert np.all(np.isfinite(vals)), "NaN/Inf eigenvalues"
    assert np.all(np.isfinite(np.asarray(res.residual_norms)))
    if bool(res.converged):
        A64 = np.asarray(A, np.float64)
        if gen:
            expected = scipy.linalg.eigh(A64, np.asarray(B, np.float64),
                                         eigvals_only=True)[:k]
        else:
            expected = scipy.linalg.eigh(A64, eigvals_only=True)[:k]
        np.testing.assert_allclose(vals, expected,
                                   atol=1e-7 if dtype == "float64"
                                   else 5e-4)


def _sharded_cases():
    rng = np.random.default_rng(77)
    cases = []
    for i in range(6):
        nmul = int(rng.integers(2, 30))        # n = 8 * nmul
        k = int(rng.integers(1, 4))
        gen = bool(rng.integers(0, 2))
        refined = bool(rng.integers(0, 2))
        dtype = str(rng.choice(["float64", "float32"]))
        cases.append((i, 8 * nmul, k, gen, refined, dtype))
    return cases


@pytest.mark.parametrize("seed,n,k,gen,refined,dtype", _sharded_cases())
def test_random_sharded_config(seed, n, k, gen, refined, dtype):
    """Random GSPMD configurations on the 8-device CPU mesh: odd row
    multiples, generalized pencils, and the refined tree-strategy path
    must all partition cleanly and match scipy when they converge."""
    from fortran_davidson_tpu.parallel import default_mesh, \
        eigensolve_sharded
    mesh = default_mesh(8)
    A = generate_diagonal_dominant(n, 1e-3, key=jax.random.PRNGKey(seed))
    B = (generate_diagonal_dominant(n, 1e-3, diag_val=1.0,
                                    key=jax.random.PRNGKey(seed + 50))
         if gen else None)
    if dtype == "float32":
        A = jnp.asarray(np.asarray(A), jnp.float32)
        B = None if B is None else jnp.asarray(np.asarray(B), jnp.float32)
    tol = 1e-8 if dtype == "float64" else 1e-4
    res = eigensolve_sharded(A, k, mesh, second_matrix=B, tolerance=tol,
                             max_iterations=300, dtype=dtype,
                             refined=refined)
    res.block_until_ready()
    vals = np.asarray(res.eigenvalues)
    assert np.all(np.isfinite(vals))
    if bool(res.converged):
        A64 = np.asarray(A, np.float64)
        if gen:
            expected = scipy.linalg.eigh(A64, np.asarray(B, np.float64),
                                         eigvals_only=True)[:k]
        else:
            expected = scipy.linalg.eigh(A64, eigvals_only=True)[:k]
        np.testing.assert_allclose(vals, expected,
                                   atol=1e-7 if dtype == "float64"
                                   else 5e-3)


def _chunked_cases():
    rng = np.random.default_rng(1234)
    cases = []
    for i in range(6):
        n = int(rng.integers(40, 2400))
        k = int(rng.integers(1, 4))
        method = str(rng.choice(["DPR", "GJD", "OLSEN"]))
        expansion = str(rng.choice(["doubling", "lowest-k"]))
        gen = bool(rng.integers(0, 2))
        dtype = str(rng.choice(["float64", "float32"]))
        cases.append((i, n, k, method, expansion, gen, dtype))
    return cases


@pytest.mark.parametrize("seed,n,k,method,expansion,gen,dtype",
                         _chunked_cases())
def test_random_chunked_carry_bit_identity(seed, n, k, method, expansion,
                                           gen, dtype):
    """Random refined configurations: the chunked carry layout must give
    BIT-identical trajectories to the flat layout (the contract the
    layout-wall escape rests on — see tests/test_chunked_carry.py for the
    targeted cases)."""
    A = generate_diagonal_dominant(n, 1e-3, key=jax.random.PRNGKey(seed))
    B = (generate_diagonal_dominant(n, 1e-3, diag_val=1.0,
                                    key=jax.random.PRNGKey(seed + 900))
         if gen else None)
    if dtype == "float32":
        A = jnp.asarray(np.asarray(A), jnp.float32)
        B = None if B is None else jnp.asarray(np.asarray(B), jnp.float32)
    tol = 1e-8 if dtype == "float64" else 1e-5
    out = {}
    for layout in ("flat", "chunked"):
        res = fdt.eigensolve(A, k, second_matrix=B, method=method,
                             tolerance=tol, max_iterations=80,
                             dtype=dtype, expansion=expansion,
                             refined=True, carry_layout=layout)
        res.block_until_ready()
        out[layout] = res
    assert int(out["flat"].iterations) == int(out["chunked"].iterations)
    np.testing.assert_array_equal(
        np.asarray(out["flat"].residual_history),
        np.asarray(out["chunked"].residual_history))
    np.testing.assert_array_equal(np.asarray(out["flat"].eigenvalues),
                                  np.asarray(out["chunked"].eigenvalues))


def _sell_cases():
    rng = np.random.default_rng(55)
    return [(i, int(rng.integers(8, 900)), float(rng.uniform(0, 0.2)))
            for i in range(8)]


@pytest.mark.parametrize("seed,n,density", _sell_cases())
def test_random_sell_matches_dense(seed, n, density):
    """Random symmetric COO patterns (incl. duplicates, empty rows):
    SlicedELLOperator must match the dense oracle exactly at f64."""
    from fortran_davidson_tpu.ops.sparse import SlicedELLOperator
    rng = np.random.default_rng(seed)
    nnz = int(density * n * n) + 1
    i = rng.integers(0, n, nnz)
    j = rng.integers(0, n, nnz)
    v = rng.standard_normal(nnz)
    rows = np.concatenate([i, j])
    cols = np.concatenate([j, i])
    vals = np.concatenate([v, v])
    dense = np.zeros((n, n))
    np.add.at(dense, (rows, cols), vals)
    sell = SlicedELLOperator.from_coo(rows, cols, vals, n)
    np.testing.assert_allclose(np.asarray(sell.to_dense()), dense,
                               atol=1e-12)
    x = rng.standard_normal((n, 3))
    np.testing.assert_allclose(np.asarray(sell.matmat(jnp.asarray(x))),
                               dense @ x, atol=1e-10)
    np.testing.assert_allclose(np.asarray(sell.diagonal()),
                               np.diag(dense), atol=1e-12)

"""Chunked-carry engine (``carry_layout="chunked"``).

The refined solver's tall carries (V, AV, BV) are stored pre-chunked as
``(n/c, c, m_max)`` — the layout the compensated Gram's batched einsum
consumes — so the per-iteration ``(n, m) -> (n/c, c, m)`` relayout
copies never appear in the compiled graph. Every consumer
contracts with the same per-element order as the flat layout, so the
entire trajectory must be BIT-IDENTICAL — these tests pin exactly that
(equality, not closeness).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fortran_davidson_tpu import eigensolve
from fortran_davidson_tpu.config import DavidsonOptions
from fortran_davidson_tpu.models.generators import (
    generate_diagonal_dominant, surrogate_hamiltonian)
from fortran_davidson_tpu.utils.errors import InvalidOptionsError


def _solve_pair(op, k, **kw):
    """Solve with flat and chunked carries; everything else identical."""
    flat = eigensolve(op, k, carry_layout="flat", **kw)
    chunked = eigensolve(op, k, carry_layout="chunked", **kw)
    return flat, chunked


def _assert_bit_identical(flat, chunked):
    assert int(flat.iterations) == int(chunked.iterations)
    assert bool(flat.converged) == bool(chunked.converged)
    np.testing.assert_array_equal(np.asarray(flat.eigenvalues),
                                  np.asarray(chunked.eigenvalues))
    np.testing.assert_array_equal(np.asarray(flat.eigenvectors),
                                  np.asarray(chunked.eigenvectors))
    np.testing.assert_array_equal(np.asarray(flat.residual_history),
                                  np.asarray(chunked.residual_history))
    np.testing.assert_array_equal(np.asarray(flat.subspace_dims),
                                  np.asarray(chunked.subspace_dims))


class TestBitIdentity:
    # n values exercise the chunk-size reduction (_chunk divides n):
    # 4096 -> one slab, 1536 -> c=512, 1000 -> c=125? (power-of-two
    # halving: 4096..1 until it divides).
    @pytest.mark.parametrize("n", [1536, 4096])
    @pytest.mark.parametrize("expansion", ["lowest-k", "doubling"])
    def test_dpr_refined_standard(self, n, expansion):
        op = surrogate_hamiltonian(n, dtype=jnp.float32)
        flat, chunked = _solve_pair(
            op, 3, method="DPR", tolerance=1e-5, dtype="float32",
            refined=True, expansion=expansion, max_iterations=60)
        _assert_bit_identical(flat, chunked)

    def test_olsen_refined(self):
        op = surrogate_hamiltonian(2048, dtype=jnp.float32)
        flat, chunked = _solve_pair(
            op, 2, method="OLSEN", tolerance=1e-5, dtype="float32",
            refined=True, expansion="lowest-k", max_iterations=60)
        _assert_bit_identical(flat, chunked)

    def test_gjd_refined(self):
        A = generate_diagonal_dominant(512, 1e-3, dtype=jnp.float32)
        flat, chunked = _solve_pair(
            A, 2, method="GJD", tolerance=1e-6, dtype="float32",
            refined=True, max_iterations=40)
        _assert_bit_identical(flat, chunked)

    def test_gjd_warm_start_refined(self):
        """The warm-start carry (corr_prev, flat (n, kk)) threads through
        the chunked engine's cond branches; trajectories stay
        bit-identical across layouts."""
        op = surrogate_hamiltonian(2048, dtype=jnp.float32)
        flat, chunked = _solve_pair(
            op, 2, method="GJD", tolerance=1e-5, dtype="float32",
            refined=True, expansion="lowest-k", max_iterations=40,
            gjd_preconditioner="dpr", gjd_warm_start=True)
        _assert_bit_identical(flat, chunked)
        assert int(flat.inner_iterations) == int(chunked.inner_iterations)

    def test_generalized_refined(self):
        A = generate_diagonal_dominant(768, 1e-3, dtype=jnp.float32)
        B = generate_diagonal_dominant(768, 1e-3, diag_val=1.0,
                                       dtype=jnp.float32)
        flat, chunked = _solve_pair(
            A, 2, second_matrix=B, method="DPR", tolerance=1e-6,
            dtype="float32", refined=True, max_iterations=60)
        _assert_bit_identical(flat, chunked)

    def test_final_polish_and_warm_start(self):
        op = surrogate_hamiltonian(2048, dtype=jnp.float32)
        base = eigensolve(op, 2, tolerance=1e-3, dtype="float32",
                          max_iterations=40)
        kw = dict(method="DPR", tolerance=1e-8, dtype="float32",
                  refined=True, final_polish=2, expansion="lowest-k",
                  max_iterations=60,
                  initial_vectors=np.asarray(base.eigenvectors))
        flat, chunked = _solve_pair(op, 2, **kw)
        _assert_bit_identical(flat, chunked)
        assert bool(chunked.converged)

    def test_f64_refined(self):
        # The chunked layout is dtype-agnostic; f64 small-problem parity
        # configurations must round-trip bit-identically too.
        A = generate_diagonal_dominant(600, 1e-3)
        flat, chunked = _solve_pair(A, 3, method="DPR", tolerance=1e-9,
                                    refined=True, max_iterations=60)
        _assert_bit_identical(flat, chunked)
        assert bool(chunked.converged)


class TestInteractions:
    def test_locking(self):
        op = surrogate_hamiltonian(1536, dtype=jnp.float32)
        flat, chunked = _solve_pair(
            op, 3, method="DPR", tolerance=1e-5, dtype="float32",
            refined=True, locking=True, expansion="lowest-k",
            max_iterations=60)
        _assert_bit_identical(flat, chunked)

    def test_chebyshev_restarts(self):
        A = generate_diagonal_dominant(700, 1e-2, dtype=jnp.float32)
        flat, chunked = _solve_pair(
            A, 2, method="DPR", tolerance=1e-5, dtype="float32",
            refined=True, cheb_degree=4, max_dim_sub=8,
            max_iterations=80)
        _assert_bit_identical(flat, chunked)

    def test_checkpoint_resume(self, tmp_path):
        # The chunked (n/c, c, m_max) state round-trips through orbax
        # and resumes bit-exactly.
        from fortran_davidson_tpu import eigensolve_checkpointed
        op = surrogate_hamiltonian(1536, dtype=jnp.float32)
        kw = dict(method="DPR", tolerance=1e-6, dtype="float32",
                  refined=True, carry_layout="chunked",
                  expansion="lowest-k", max_iterations=40)
        full = eigensolve_checkpointed(op, 2, str(tmp_path / "a"),
                                       every=50, **kw)

        def interrupt(state):
            raise KeyboardInterrupt

        with pytest.raises(KeyboardInterrupt):
            eigensolve_checkpointed(op, 2, str(tmp_path / "b"), every=1,
                                    callbacks=(interrupt,), **kw)
        resumed = eigensolve_checkpointed(op, 2, str(tmp_path / "b"),
                                          every=50, **kw)
        assert int(resumed.iterations) == int(full.iterations)
        np.testing.assert_array_equal(np.asarray(resumed.eigenvalues),
                                      np.asarray(full.eigenvalues))


class TestValidation:
    def test_requires_refined(self):
        with pytest.raises(InvalidOptionsError):
            DavidsonOptions(carry_layout="chunked", refined=False)

    def test_unknown_layout(self):
        with pytest.raises(InvalidOptionsError):
            DavidsonOptions(carry_layout="banana")

    def test_qr_ortho_rejected(self):
        # The Householder-QR cleanup sweep projects with a plain Gram
        # (no bit-identical chunked form) — the combination must be
        # rejected at validation, not crash at trace time.
        with pytest.raises(InvalidOptionsError, match="cholqr2"):
            DavidsonOptions(carry_layout="chunked", refined=True,
                            orthonormalization="qr")

    def test_sharded_accepts_chunked(self):
        # Round 5 lifted the single-device restriction: the GSPMD engine
        # runs chunked carries with shard-aligned chunks (whole chunks
        # per device). A small solve must run, not raise.
        from fortran_davidson_tpu.parallel import eigensolve_sharded
        from fortran_davidson_tpu.parallel.mesh import default_mesh
        op = surrogate_hamiltonian(2048, dtype=jnp.float32)
        res = eigensolve_sharded(op, 2, default_mesh(8), dtype="float32",
                                 refined=True, carry_layout="chunked",
                                 tolerance=1e-3, max_iterations=30)
        assert bool(res.converged)


def test_auto_carry_layout_resolution():
    """``carry_layout="auto"`` (the default) resolves to chunked exactly
    when the chunked engine's requirements hold: refined + cholqr2 +
    a usable power-of-two chunk divisor of n (per-shard under GSPMD)."""
    from fortran_davidson_tpu.config import resolve_options

    def layout(opts, n=100_096, sharded=False, div=1):
        return resolve_options(opts, 3, n, False, sharded=sharded,
                               shard_row_divisor=div).carry_layout

    assert layout(DavidsonOptions(refined=True)) == "chunked"
    assert layout(DavidsonOptions()) == "flat"                # not refined
    # Round 5: the GSPMD engine runs chunked too, with shard-aligned
    # chunks — n=100_096 over 8 shards leaves a 12512-row shard whose
    # largest power-of-two chunk divisor is 32 (< 256): stay flat; a
    # shard-friendly n goes chunked.
    assert layout(DavidsonOptions(refined=True),
                  sharded=True, div=8) == "flat"
    assert layout(DavidsonOptions(refined=True), n=65536,
                  sharded=True, div=8) == "chunked"
    assert layout(DavidsonOptions(refined=True,
                                  orthonormalization="qr")) == "flat"
    # A prime-ish n degrades the chunk divisor toward 1 row: stay flat.
    assert layout(DavidsonOptions(refined=True), n=100_097) == "flat"
    # Explicit choices pass through untouched.
    assert layout(DavidsonOptions(refined=True,
                                  carry_layout="flat")) == "flat"
    assert layout(DavidsonOptions(refined=True,
                                  carry_layout="chunked")) == "chunked"


def test_auto_default_solves_chunked_bit_identical():
    """A refined solve under the auto default must produce the exact
    flat-layout trajectory (the bit-identity contract is what makes the
    default flip safe)."""
    A = generate_diagonal_dominant(768, 1e-3)
    kw = dict(method="DPR", tolerance=1e-10, refined=True, final_polish=1)
    auto = eigensolve(A, 3, **kw)              # default carry_layout="auto"
    flat = eigensolve(A, 3, carry_layout="flat", **kw)
    _assert_bit_identical(flat, auto)


class TestShardedChunkedCarries:
    """Round-5: the GSPMD engine runs the chunked carry layout too.

    At n where the default chunk divides the per-shard row count, every
    Gram in the pipeline chunks identically in both layouts, so the
    sharded chunked trajectory is BIT-IDENTICAL to the sharded flat one
    — the same contract the single-device engine pins."""

    def test_sharded_chunked_bit_parity_vs_flat(self):
        import jax.numpy as jnp
        import numpy as np
        from fortran_davidson_tpu.models.generators import \
            surrogate_hamiltonian
        from fortran_davidson_tpu.parallel import (default_mesh,
                                                   eigensolve_sharded)

        n = 65536  # chunk 4096 divides n/8 = 8192: bitwise-comparable
        op = surrogate_hamiltonian(n, dtype=jnp.float32)
        mesh = default_mesh(8)
        common = dict(method="DPR", tolerance=1e-6,
                      relative_tolerance=True, max_iterations=25,
                      dtype="float32", expansion="lowest-k", refined=True)
        flat = eigensolve_sharded(op, 3, mesh, carry_layout="flat",
                                  **common)
        chunked = eigensolve_sharded(op, 3, mesh, carry_layout="chunked",
                                     **common)
        assert int(flat.iterations) == int(chunked.iterations)
        np.testing.assert_array_equal(np.asarray(flat.eigenvalues),
                                      np.asarray(chunked.eigenvalues))
        np.testing.assert_array_equal(np.asarray(flat.residual_norms),
                                      np.asarray(chunked.residual_norms))
        np.testing.assert_array_equal(np.asarray(flat.eigenvectors),
                                      np.asarray(chunked.eigenvectors))

    def test_sharded_chunked_with_polish_converges(self):
        import jax.numpy as jnp
        import numpy as np
        from fortran_davidson_tpu.ops.sparse import generate_banded_bsr
        from fortran_davidson_tpu.parallel import (default_mesh,
                                                   eigensolve_sharded)

        bsr = generate_banded_bsr(64, 16, bandwidth=1, coupling=1e-3,
                                  dtype=jnp.float32)
        mesh = default_mesh(8)
        res = eigensolve_sharded(bsr, 3, mesh, method="DPR",
                                 tolerance=1e-8, relative_tolerance=True,
                                 dtype="float32", expansion="lowest-k",
                                 refined=True, final_polish=3,
                                 carry_layout="chunked",
                                 max_iterations=60)
        assert bool(res.converged)
        assert float(np.max(np.asarray(res.residual_norms))) < 1e-8

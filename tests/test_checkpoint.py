"""Checkpoint/resume and chunked-driver semantics.

No reference analogue (SURVEY.md §5: "Checkpoint/resume: none") — the
oracle is the one-shot engine: chunked and resumed solves must reproduce
its iterates bit-for-bit (same iteration counts, same eigenvalues).
"""

import numpy as np
import pytest

import fortran_davidson_tpu as fdt
from fortran_davidson_tpu.checkpoint import (eigensolve_checkpointed,
                                             latest_step, restore_state,
                                             save_state)
from fortran_davidson_tpu.config import DavidsonOptions, resolve_options
from fortran_davidson_tpu.core.loop import get_stepper, run_chunked
from fortran_davidson_tpu.models.generators import generate_diagonal_dominant
from fortran_davidson_tpu.ops.operators import DenseOperator
from fortran_davidson_tpu.utils.observability import ConvergenceLogger


@pytest.fixture(scope="module")
def problem():
    A = generate_diagonal_dominant(80, 1e-3)
    ref = fdt.eigensolve(A, 3, tolerance=1e-8)
    ref.block_until_ready()
    return A, ref


class TestChunkedDriver:
    def test_matches_one_shot(self, problem):
        A, ref = problem
        op = DenseOperator(A)
        cfg = resolve_options(DavidsonOptions(), 3, 80, generalized=False)
        res = run_chunked(cfg, op, None, every=2)
        assert int(res.iterations) == int(ref.iterations)
        np.testing.assert_array_equal(np.asarray(res.eigenvalues),
                                      np.asarray(ref.eigenvalues))

    def test_convergence_logger_callback(self, problem):
        A, ref = problem
        op = DenseOperator(A)
        cfg = resolve_options(DavidsonOptions(), 3, 80, generalized=False)
        log = ConvergenceLogger()
        res = run_chunked(cfg, op, None, every=1, callbacks=(log,))
        assert len(log.records) == int(res.iterations)
        assert log.records[-1]["converged_pairs"] == 3
        # Residuals in the log match the device-side history.
        hist = np.asarray(res.residual_history)
        for rec in log.records:
            row = hist[rec["iteration"] - 1]
            assert abs(rec["max_residual"] - row.max()) < 1e-14


class TestCheckpointResume:
    def test_save_restore_roundtrip(self, problem, tmp_path):
        A, _ = problem
        op = DenseOperator(A)
        cfg = resolve_options(DavidsonOptions(), 3, 80, generalized=False)
        init, step = get_stepper(cfg)
        st = init(op, None)
        path = save_state(tmp_path, st)
        assert latest_step(tmp_path) == 0
        import jax
        template = jax.eval_shape(lambda: init(op, None))
        restored = restore_state(str(tmp_path), template)
        for key in st:
            np.testing.assert_array_equal(np.asarray(st[key]),
                                          np.asarray(restored[key]), key)

    def test_checkpointed_solve_matches(self, problem, tmp_path):
        A, ref = problem
        res = eigensolve_checkpointed(A, 3, str(tmp_path), every=2)
        assert int(res.iterations) == int(ref.iterations)
        np.testing.assert_array_equal(np.asarray(res.eigenvalues),
                                      np.asarray(ref.eigenvalues))
        assert latest_step(tmp_path) == int(ref.iterations)

    def test_resume_after_interrupt(self, problem, tmp_path):
        A, ref = problem

        class Crash(RuntimeError):
            pass

        def crash_after_first_chunk(state):
            raise Crash  # simulates the process dying mid-solve

        with pytest.raises(Crash):
            eigensolve_checkpointed(A, 3, str(tmp_path), every=1,
                                    callbacks=(crash_after_first_chunk,))
        saved = latest_step(tmp_path)
        assert saved == 1  # one chunk survived on disk
        # Resume (same options — checkpoints are shape-bound to the
        # configuration): completes with the SAME totals as an
        # uninterrupted solve.
        res2 = eigensolve_checkpointed(A, 3, str(tmp_path), every=1)
        assert bool(res2.converged)
        assert int(res2.iterations) == int(ref.iterations)
        np.testing.assert_array_equal(np.asarray(res2.eigenvalues),
                                      np.asarray(ref.eigenvalues))


class TestShardedCheckpoint:
    def test_sharded_checkpointed_solve(self, problem, tmp_path):
        from fortran_davidson_tpu.parallel import default_mesh
        A, ref = problem
        mesh = default_mesh(8)
        res = eigensolve_checkpointed(A, 3, str(tmp_path), every=2, mesh=mesh)
        assert bool(res.converged)
        assert int(res.iterations) == int(ref.iterations)
        np.testing.assert_allclose(np.asarray(res.eigenvalues),
                                   np.asarray(ref.eigenvalues), atol=1e-12)
        # resume path with a mesh
        res2 = eigensolve_checkpointed(A, 3, str(tmp_path), every=2,
                                       mesh=mesh)
        assert int(res2.iterations) == int(ref.iterations)


class TestMeshRefinedCheckpoint:
    def test_mesh_refined_resolves_sharded_layout(self, tmp_path):
        """Advisor r3 (high): a mesh+refined checkpointed solve must
        resolve carry_layout='auto' with sharded=True — i.e. to 'flat'
        — instead of crashing on the single-device-only chunked
        layout. n=512 is exactly a shape where the single-device auto
        resolution WOULD pick chunked (_chunk(512) = 512 >= 256)."""
        import jax.numpy as jnp
        from fortran_davidson_tpu.parallel import default_mesh
        A = generate_diagonal_dominant(512, 1e-3)
        A32 = jnp.asarray(np.asarray(A), jnp.float32)
        mesh = default_mesh(8)
        res = eigensolve_checkpointed(
            A32, 3, str(tmp_path), every=4, mesh=mesh, dtype="float32",
            refined=True, tolerance=1e-6, max_iterations=80)
        assert bool(res.converged)
        # And the resume leg of the same long-pod-run use case.
        res2 = eigensolve_checkpointed(
            A32, 3, str(tmp_path), every=4, mesh=mesh, dtype="float32",
            refined=True, tolerance=1e-6, max_iterations=80)
        assert bool(res2.converged)
        assert int(res2.iterations) == int(res.iterations)


class TestAutoLayoutResume:
    def test_auto_resume_adopts_recorded_flat_layout(self, tmp_path):
        """Advisor r3 (medium): checkpoints written before the 'auto'
        default (fingerprint records carry_layout='flat') must resume
        under default options even where 'auto' now resolves 'chunked'
        — the resume rebinds 'auto' to the recorded layout."""
        import jax.numpy as jnp
        A = generate_diagonal_dominant(512, 1e-3)
        A32 = jnp.asarray(np.asarray(A), jnp.float32)
        d = str(tmp_path / "flat_ckpt")
        common = dict(every=2, dtype="float32", refined=True,
                      tolerance=1e-6, max_iterations=80)

        class Crash(RuntimeError):
            pass

        calls = []

        def crash_once(state):
            calls.append(1)
            if len(calls) == 1:
                raise Crash

        # Writer: an explicit-flat run (stands in for a pre-'auto'
        # checkpoint) interrupted mid-solve.
        with pytest.raises(Crash):
            eigensolve_checkpointed(A32, 3, d, carry_layout="flat",
                                    callbacks=(crash_once,), **common)
        assert latest_step(d) is not None
        # Resumer: default options — 'auto' resolves 'chunked' at this
        # shape, but the resume must adopt the recorded 'flat'.
        res = eigensolve_checkpointed(A32, 3, d, **common)
        assert bool(res.converged)
        # The oracle: an uninterrupted flat solve.
        ref = fdt.eigensolve(A32, 3, carry_layout="flat",
                             **{k: v for k, v in common.items()
                                if k != "every"})
        assert int(res.iterations) == int(ref.iterations)
        np.testing.assert_array_equal(np.asarray(res.eigenvalues),
                                      np.asarray(ref.eigenvalues))

    def test_explicit_layout_mismatch_still_raises(self, tmp_path):
        """An EXPLICIT layout request that contradicts the checkpoint
        keeps failing loudly (only 'auto' is rebound)."""
        import jax.numpy as jnp
        from fortran_davidson_tpu.utils.errors import InvalidOptionsError
        A = generate_diagonal_dominant(512, 1e-3)
        A32 = jnp.asarray(np.asarray(A), jnp.float32)
        d = str(tmp_path / "explicit_ckpt")
        common = dict(every=2, dtype="float32", refined=True,
                      tolerance=1e-6, max_iterations=80)

        class Crash(RuntimeError):
            pass

        calls = []

        def crash_once(state):
            calls.append(1)
            if len(calls) == 1:
                raise Crash

        with pytest.raises(Crash):
            eigensolve_checkpointed(A32, 3, d, carry_layout="flat",
                                    callbacks=(crash_once,), **common)
        with pytest.raises(InvalidOptionsError, match="different solver"):
            eigensolve_checkpointed(A32, 3, d, carry_layout="chunked",
                                    **common)


class TestPodResharding:
    def test_resume_on_different_mesh_size(self, problem, tmp_path):
        """Elastic-restart shape: a checkpoint written on an 8-device
        mesh resumes on a 4-device mesh (the restore template carries
        the CURRENT mesh's shardings, so orbax reshards on load) and
        completes with the single-device trajectory."""
        from fortran_davidson_tpu.parallel import default_mesh
        A, ref = problem

        class Crash(RuntimeError):
            pass

        calls = []

        def crash_once(state):
            calls.append(1)
            if len(calls) == 1:
                raise Crash

        with pytest.raises(Crash):
            eigensolve_checkpointed(A, 3, str(tmp_path), every=2,
                                    mesh=default_mesh(8),
                                    callbacks=(crash_once,))
        assert latest_step(tmp_path) is not None
        res = eigensolve_checkpointed(A, 3, str(tmp_path), every=2,
                                      mesh=default_mesh(4))
        assert bool(res.converged)
        assert int(res.iterations) == int(ref.iterations)
        np.testing.assert_allclose(np.asarray(res.eigenvalues),
                                   np.asarray(ref.eigenvalues), atol=1e-12)
        # The resumed state rides the NEW mesh: the eigenvector output
        # is sharded over 4 devices.
        assert res.eigenvectors.sharding.mesh.size == 4


class TestConfigFingerprint:
    def test_mismatched_resume_raises_clearly(self, problem, tmp_path):
        from fortran_davidson_tpu.utils.errors import InvalidOptionsError
        A, B = problem
        d = str(tmp_path / "ckpt_fp")
        fdt.eigensolve_checkpointed(A, 2, d, every=2, tolerance=1e-8,
                                    max_iterations=40)
        # Different max_iterations => different history shapes; must fail
        # with the explicit configuration message, not an orbax shape
        # error (VERDICT r1 weak #8).
        with pytest.raises(InvalidOptionsError, match="different solver"):
            fdt.eigensolve_checkpointed(A, 2, d, every=2, tolerance=1e-8,
                                        max_iterations=77)
        # Same options resume cleanly.
        res = fdt.eigensolve_checkpointed(A, 2, d, every=2, tolerance=1e-8,
                                          max_iterations=40)
        assert bool(res.converged)


class TestRefinedCheckpoint:
    """The refined path's extra state (plateau tracker best_err/no_prog)
    must survive save/resume, and the in-solve final polish must run on
    the chunked/checkpointed driver exactly as on the one-shot engine."""

    def _solve(self, A32, path=None, **kw):
        common = dict(method="DPR", tolerance=1e-7, dtype="float32",
                      refined=True, final_polish=2, max_iterations=120)
        common.update(kw)
        if path is None:
            return fdt.eigensolve(A32, 3, **common)
        return eigensolve_checkpointed(A32, 3, path, every=2, **common)

    def test_refined_resume_matches_uninterrupted(self, tmp_path):
        import jax.numpy as jnp
        A = generate_diagonal_dominant(150, 1e-3)
        A32 = jnp.asarray(np.asarray(A), jnp.float32)
        ref = self._solve(A32)

        class Crash(RuntimeError):
            pass

        calls = []

        def crash_once(state):
            calls.append(1)
            if len(calls) == 1:
                raise Crash

        with pytest.raises(Crash):
            eigensolve_checkpointed(A32, 3, str(tmp_path), every=2,
                                    method="DPR", tolerance=1e-7,
                                    dtype="float32", refined=True,
                                    final_polish=2, max_iterations=120,
                                    callbacks=(crash_once,))
        assert latest_step(tmp_path) >= 1
        res = self._solve(A32, path=str(tmp_path))
        assert bool(res.converged)
        assert int(res.iterations) == int(ref.iterations)
        np.testing.assert_array_equal(np.asarray(res.eigenvalues),
                                      np.asarray(ref.eigenvalues))
        # The polish ran: true residuals below the f32 one-shot floor.
        assert float(np.max(np.asarray(res.residual_norms))) < 1e-7


def test_missing_orbax_is_a_named_error(monkeypatch, tmp_path):
    import sys

    from fortran_davidson_tpu import checkpoint
    from fortran_davidson_tpu.utils.errors import MissingDependencyError
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    with pytest.raises(MissingDependencyError, match="orbax"):
        checkpoint.save_state(str(tmp_path), {"it": 0})

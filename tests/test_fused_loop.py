"""Incremental-H (fused SpMM+Gram) Davidson engine.

The operators' ``matmat_with_gram`` (SpMM + Gram) is consumed by the
solver loop itself. The engine
carries the projected matrix H = VᵀAV in the loop state: seeded with one
full Gram, extended at every expansion by the fused kernel's
``G = Vᵀ(AQ)`` block (computed in the same operator sweep that produces
AQ), and re-seeded at collapses. Identical in exact arithmetic to the
recomputed-Gram engine (CGS2 never touches admitted basis columns).
Reference hot pair: ``/root/reference/src/davidson.f90:131,380``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import fortran_davidson_tpu as fdt
from fortran_davidson_tpu.config import (DavidsonOptions, InvalidOptionsError,
                                         resolve_options)
from fortran_davidson_tpu.core import loop as L
from fortran_davidson_tpu.ops.sparse import (generate_banded_bsr,
                                             quantize_banded_int8)


def _bsr(nbr=128, bs=16, seed=0):
    return generate_banded_bsr(nbr, bs, bandwidth=1, coupling=1e-3,
                               seed=seed, dtype=jnp.float32)


KW = dict(method="DPR", tolerance=1e-4, relative_tolerance=True,
          dtype="float32", expansion="lowest-k", max_iterations=60)


class TestFusedEngine:
    def test_matches_recomputed_gram_engine(self):
        # fused_gram="on" forces the incremental-H engine (the "auto"
        # width gate keeps it off below 128-wide blocks — see
        # DavidsonOptions.fused_gram).
        op = _bsr()
        on = fdt.eigensolve(op, 4, fused_gram="on", **KW)
        off = fdt.eigensolve(op, 4, fused_gram="off", **KW)
        assert bool(on.converged) and bool(off.converged)
        np.testing.assert_allclose(np.asarray(on.eigenvalues),
                                   np.asarray(off.eigenvalues), atol=1e-5)
        # Same schedule class: iteration counts within a couple.
        assert abs(int(on.iterations) - int(off.iterations)) <= 2

    def test_engine_flag_actually_set(self):
        # The solver gate must enable the fused engine for a capable
        # operator under the qualifying configuration.
        op = _bsr()
        opts = DavidsonOptions(**{k: v for k, v in KW.items()
                                  if k not in ("max_iterations",)},
                               max_iterations=60)
        cfg = resolve_options(opts, 4, op.shape[0], generalized=False)
        cfg_f = dataclasses.replace(cfg, fused_gram=True)
        res = L.get_engine(cfg_f)(op, None)
        assert bool(res.converged)
        st = L.init_state(cfg_f, op, None)
        assert "H" in st

    def test_collapse_reseeds(self):
        # Tight max_dim forces collapses; the re-seeded H must keep the
        # trajectory convergent and correct.
        op = _bsr(nbr=64)
        res = fdt.eigensolve(op, 3, max_dim_sub=8, init_dim=6, **KW)
        assert bool(res.converged)
        import scipy.linalg
        want = scipy.linalg.eigh(np.asarray(op.to_dense(), np.float64),
                                 eigvals_only=True)[:3]
        np.testing.assert_allclose(np.asarray(res.eigenvalues), want,
                                   atol=1e-4)
        assert int(np.asarray(res.subspace_dims).max()) <= 11

    def test_quantized_operator(self):
        q = quantize_banded_int8(_bsr())
        res = fdt.eigensolve(q, 4, **KW)
        assert bool(res.converged)
        np.testing.assert_allclose(np.asarray(res.eigenvalues),
                                   [1.0, 2.0, 3.0, 4.0], atol=1e-3)

    def test_gjd_composes(self):
        op = _bsr(nbr=64)
        res = fdt.eigensolve(op, 2, **dict(KW, method="GJD",
                                           gjd_preconditioner="dpr"))
        assert bool(res.converged)

    def test_loop_guard_rejects_bad_config(self):
        op = _bsr(nbr=64)
        opts = DavidsonOptions(dtype="float32", refined=True,
                               expansion="lowest-k")
        cfg = resolve_options(opts, 2, op.shape[0], generalized=False)
        cfg = dataclasses.replace(cfg, fused_gram=True)
        with pytest.raises(ValueError, match="fused_gram"):
            L.run_state(cfg, op, None, L.init_state(cfg, op, None),
                        A_off=op.offdiag())

    def test_option_validation(self):
        with pytest.raises(InvalidOptionsError):
            DavidsonOptions(fused_gram="yes")

    def test_refined_path_not_fused(self):
        # refined=True must keep the compensated-Gram engine (the fused
        # f32 gram is far above DS precision) — and still converge.
        op = _bsr()
        res = fdt.eigensolve(op, 3, **dict(KW, refined=True,
                                           tolerance=1e-6))
        assert bool(res.converged)


class TestAutoWidthGate:
    """fused_gram='auto' engages only for an operator with a fused
    SpMM+Gram kernel — none has one, so it never engages."""

    def test_auto_stays_two_pass_at_narrow_k(self):
        # k=4: the solver must NOT flip fused_gram on (trajectory equals
        # the two-pass engine bit-for-bit).
        op = _bsr()
        a = fdt.eigensolve(op, 4, fused_gram="auto", **KW)
        off = fdt.eigensolve(op, 4, fused_gram="off", **KW)
        np.testing.assert_array_equal(np.asarray(a.eigenvalues),
                                      np.asarray(off.eigenvalues))
        assert int(a.iterations) == int(off.iterations)

    def test_on_forces_fused_at_narrow_k(self):
        op = _bsr()
        on = fdt.eigensolve(op, 4, fused_gram="on", **KW)
        assert bool(on.converged)

    def test_on_still_respects_structural_gates(self):
        # refined path must never run the fused engine even when forced.
        op = _bsr()
        r = fdt.eigensolve(op, 4, fused_gram="on", refined=True, **KW)
        assert bool(r.converged)

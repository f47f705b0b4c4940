"""Collective audit of the sharded program (parallel/scaling.py).

Unit tiers test the HLO collective parser and the audits; the
integration tier compiles the real sharded stepper on
the 8-device CPU mesh at two row counts and asserts the property the
whole model rests on: per-iteration collective traffic is byte-identical
at both n (row locality — halo slabs and Gram partials only).
"""

import pytest

from fortran_davidson_tpu.parallel.scaling import (
    assert_n_independent, audit_no_tall_collectives, collective_stats,
    probe_compiled_collectives)

_HLO = """
HloModule jit_step

%add (x: f32[], y: f32[]) -> f32[] {
  ROOT %a = f32[] add(%x, %y)
}

ENTRY %main {
  %p = f32[128,64]{1,0} parameter(0)
  %ar = f32[44,44]{1,0} all-reduce(%g), to_apply=%add
  %cp = f32[128,64]{1,0} collective-permute(%p), source_target_pairs={{0,1}}
  %cps = (f32[32,64]{1,0}, u32[]) collective-permute-start(%h), source_target_pairs={{1,0}}
  %cpd = f32[32,64]{1,0} collective-permute-done(%cps)
  %dot = f32[64,64]{1,0} dot(%p, %p)
}
"""


class TestCollectiveStats:
    def test_parses_kinds_and_bytes(self):
        s = collective_stats(_HLO)
        assert s["by_kind"]["all-reduce"]["count"] == 1
        assert s["by_kind"]["all-reduce"]["bytes"] == 44 * 44 * 4
        # plain permute + async start counted; the -done is NOT
        # double-counted.
        assert s["by_kind"]["collective-permute"]["count"] == 2
        assert s["by_kind"]["collective-permute"]["bytes"] == \
            (128 * 64 + 32 * 64) * 4
        assert s["max_single_bytes"] == 128 * 64 * 4
        assert s["total_count"] == 3

    def test_non_collectives_ignored(self):
        s = collective_stats("%d = f32[4096,4096]{1,0} dot(%a, %b)")
        assert s["total_bytes"] == 0 and s["total_count"] == 0


class TestAudits:
    def test_tall_collective_fails(self):
        s = collective_stats(_HLO)
        with pytest.raises(AssertionError, match="n-scale"):
            # cap below the 32 KB permute -> must fail loudly
            audit_no_tall_collectives(s, n_local=64, m_max=16, itemsize=4)

    def test_small_collectives_pass(self):
        s = collective_stats(_HLO)
        audit_no_tall_collectives(s, n_local=4096, m_max=64, itemsize=4)

    def test_n_independence_fails_on_mismatch(self):
        a = dict(collective_stats(_HLO), n=1000)
        b = dict(a, total_bytes=a["total_bytes"] * 2, n=2000)
        with pytest.raises(AssertionError, match="scales with n"):
            assert_n_independent(a, b)
        assert_n_independent(a, dict(a, n=2000))  # identical -> ok


class TestCompiledProbe:
    """Integration: the real sharded stepper on the 8-device CPU mesh."""

    def test_north_star_program_is_row_local(self):
        small = probe_compiled_collectives(n_devices=8, nbr=64, bs=32)
        large = probe_compiled_collectives(n_devices=8, nbr=128, bs=32)
        assert small["total_bytes"] > 0  # collectives DO exist
        assert_n_independent(small, large)
        audit_no_tall_collectives(small, small["n_local"],
                                  small["m_max"])

"""Memory-aware default basis width (round 5).

The reference default ``max_dim_sub = 10 * lowest``
(``src/davidson.f90:115-119``) is kept verbatim at parity scales, but at
large row counts the tall carries of a 10*k-wide basis may not fit one
device (a 200-wide f32 basis at 10M rows is ~17.6 GB of V+AV alone).
``resolve_options`` clamps the DEFAULT down the 4-wide lattice until the
footprint model fits the per-device memory budget, flooring at
``init_dim + 4``. On the CPU backend (no memory stats) the budget is a
fixed 12 GB, under which the 10M/f32/k=20 north star resolves to the
floor, 44. Float32 defaults are also held to the widest basis measured
to converge. An explicit ``max_dim_sub`` is never touched.
"""

import pytest

from fortran_davidson_tpu.config import (DavidsonOptions,
                                         _memory_clamped_max_dim,
                                         resolve_options)


def _default_max_dim(lowest, n, **kw):
    opts_kw = dict(dtype="float32", expansion="lowest-k")
    opts_kw.update(kw.pop("options", {}))
    return resolve_options(DavidsonOptions(**opts_kw), lowest, n,
                           generalized=False, **kw).max_dim


class TestNorthStarDefault:
    def test_10m_lowest20_resolves_to_measured_width(self):
        # eigensolve(op, 20) at 10M must get the measured single-chip
        # basis (44) without flags — previously it OOM'd at 200.
        assert _default_max_dim(20, 10_000_384) == 44

    def test_explicit_width_is_never_clamped(self):
        cfg = resolve_options(
            DavidsonOptions(dtype="float32", expansion="lowest-k",
                            max_dim_sub=200),
            20, 10_000_384, generalized=False)
        assert cfg.max_dim == 200

    def test_sharded_per_device_rows_admit_wider_default(self):
        # 10M rows over 8 devices = 1.25M local rows: the 10*k default
        # fits per-device HBM and survives unclamped.
        assert _default_max_dim(20, 10_000_384, sharded=True,
                                shard_row_divisor=8) == 200


class TestParitySchedulesUntouched:
    """The memory clamp must never move small-n defaults — the parity
    and regression tiers pin iteration schedules against the reference
    oracle at these scales."""

    @pytest.mark.parametrize("lowest,n,expect", [
        (3, 100, 30),          # reference demo scale
        (2, 50, 20),
        (6, 200_192, 60),      # bench CPU smoke scale
        (3, 1_000_448, 30),    # 1M bench scale (f32)
    ])
    def test_small_shapes_keep_reference_default(self, lowest, n, expect):
        assert _default_max_dim(lowest, n) == expect

    def test_f64_1m_unchanged(self):
        assert _default_max_dim(3, 1_000_000,
                                options=dict(dtype="float64")) == 30


class TestClampModel:
    def test_floor_is_init_dim_plus_4(self):
        # Even at absurd n the clamp stops where expansion still fires.
        md = _memory_clamped_max_dim(200, n_local=10**9, lowest=20,
                                     init_dim=40, step=20, itemsize=4,
                                     generalized=False)
        assert md == 44

    def test_descends_lattice_monotonically(self):
        # Larger n_local can only narrow the resolved width.
        widths = [
            _memory_clamped_max_dim(200, n_local=n, lowest=20,
                                    init_dim=40, step=20, itemsize=4,
                                    generalized=False)
            for n in (10**5, 10**6, 4 * 10**6, 10**7, 10**8)
        ]
        assert widths[0] == 200
        assert widths == sorted(widths, reverse=True)
        assert all(w % 4 == 0 for w in widths)

    def test_generalized_carries_narrow_sooner(self):
        std = _memory_clamped_max_dim(200, n_local=4 * 10**6, lowest=20,
                                      init_dim=40, step=20, itemsize=4,
                                      generalized=False)
        gen = _memory_clamped_max_dim(200, n_local=4 * 10**6, lowest=20,
                                      init_dim=40, step=20, itemsize=4,
                                      generalized=True)
        assert gen <= std

    def test_budget_env_override(self, monkeypatch):
        # float64: the memory budget is the only limit on the default.
        monkeypatch.setenv("FDT_CARRY_BUDGET_BYTES", "1e14")
        assert _default_max_dim(20, 10_000_384,
                                options=dict(dtype="float64")) == 200


class TestFloat32WidthLimit:
    """Float32 defaults are also held to the widest basis measured to
    converge (10M rows at m_max 64), whatever the memory budget."""

    @pytest.mark.parametrize("n,sharded,expect", [
        (10_000_384, 1, 44),     # the measured limit: floor width
        (2_097_152, 1, 200),     # 2M rows admit m_max 220
        (10_000_384, 8, 200),    # 1.25M rows per device
    ])
    def test_width_limit_ignores_memory_budget(self, monkeypatch, n,
                                               sharded, expect):
        monkeypatch.setenv("FDT_CARRY_BUDGET_BYTES", "1e14")
        kw = dict(sharded=True, shard_row_divisor=sharded) if sharded > 1 \
            else {}
        assert _default_max_dim(20, n, **kw) == expect

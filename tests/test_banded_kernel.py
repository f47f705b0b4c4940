"""The banded SpMM kernel (``ops.pallas_kernels``) and what surrounds it.

The kernel is compiled through Triton only on a GPU; here it runs under
the Pallas interpreter (``interpret=True``) and is pinned against the
plain XLA apply over block sizes, bandwidths, widths (incl. column tiles
and ``m`` padding), storage (bf16, int8, int8 read as byte pairs) and the
halo-extended input of the row-sharded path. The choice of path, the device memory budget, the
compile-cache directory, the benchmark's peak table and the smoke
script's last line are checked as host logic.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fortran_davidson_tpu.ops import pallas_kernels as pk
from fortran_davidson_tpu.ops.sparse import (_quantized_dia_apply,
                                             generate_banded_bsr,
                                             quantize_banded_int8)
from fortran_davidson_tpu.utils.errors import OperatorError


def _plain(op, x, halo):
    """The plain XLA apply of the same storage (f64 result)."""
    xin = x
    if halo:
        h = op.bandwidth * op.block_size
        xin = x[h:-h]
    if hasattr(op, "qblocks"):
        return np.asarray(_quantized_dia_apply(
            op.qblocks, op.scale_rows, op.diag, x, op.bandwidth,
            halo=halo), np.float64)
    return np.asarray(op.with_backend("xla").matmat(xin), np.float64)


def _case(nbr, bs, bw, m, dtype, halo, seed=0):
    """(operator, x, kernel output); ``dtype`` is "bf16", "int8" or
    "int8-pairs" (the int16 byte-pair view of big int8 tables, forced)."""
    base = generate_banded_bsr(nbr, bs, bandwidth=bw, seed=seed,
                               dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((nbr * bs, m)), jnp.float32)
    if halo:
        # Halo rows beyond the ring ends multiply zero blocks: fill them
        # with garbage to prove it.
        pad = jnp.asarray(rng.standard_normal((bw * bs, m)), jnp.float32)
        x = jnp.concatenate([pad, x, pad])
    if dtype.startswith("int8"):
        op = quantize_banded_int8(base)
        y = pk.banded_spmm(op.qblocks, x, op.scale_rows, op.diag,
                           bandwidth=bw, halo=halo, interpret=True,
                           pairs=dtype == "int8-pairs")
        return op, x, y
    op = base.astype(jnp.bfloat16)
    y = pk.banded_spmm(op.blocks, x, bandwidth=bw, halo=halo,
                       out_dtype=jnp.float32, interpret=True)
    return op, x, y


def _close(y, ref, tol=2e-6):
    err = np.abs(np.asarray(y, np.float64) - ref).max()
    assert err <= tol * np.abs(ref).max(), err


class TestKernelMatchesPlain:
    @pytest.mark.parametrize("nbr,bs,bw,m,dtype,halo", [
        (4, 32, 1, 20, "bf16", False),
        (5, 32, 2, 3, "bf16", False),
        (3, 32, 1, 70, "bf16", True),
        (6, 64, 2, 20, "bf16", True),
        (4, 64, 1, 20, "int8-pairs", False),
        (5, 32, 2, 40, "int8-pairs", True),
        (4, 32, 1, 20, "int8", False),
        (5, 32, 2, 3, "int8", False),
        (3, 32, 1, 70, "int8", True),
        (6, 32, 2, 20, "int8", True),
        (3, 64, 1, 64, "int8", False),
        (3, 128, 1, 20, "int8", False),
    ])
    def test_kernel_matches_plain(self, nbr, bs, bw, m, dtype, halo):
        # Same products as the plain apply, other summation order.
        op, x, y = _case(nbr, bs, bw, m, dtype, halo, seed=nbr + bs + m)
        assert y.shape == (nbr * bs, m) and y.dtype == jnp.float32
        _close(y, _plain(op, x, halo))

    @pytest.mark.parametrize("m", [1, 16, 17, 64, 65])
    def test_width_padding_and_column_tiles(self, m):
        # m is padded in registers to a power of two >= 16 and cut into
        # 64-wide column tiles; every width must round-trip exactly.
        op, x, y = _case(4, 32, 1, m, "bf16", False, seed=m)
        _close(y, _plain(op, x, False))

    def test_row_tiles_cover_large_blocks(self):
        # bs = 128 splits into row tiles per block row.
        op, x, y = _case(3, 128, 1, 20, "bf16", False, seed=3)
        _close(y, _plain(op, x, False))

    def test_int8_split_is_f32_grade(self):
        # The three-bf16-word split of x keeps f32-grade products: the
        # kernel matches the exact (f64) product of the int8 storage far
        # below a single bf16 word's 2^-9.
        op, x, y = _case(4, 32, 1, 20, "int8", False, seed=5)
        exact = np.asarray(op.to_dense(), np.float64) @ np.asarray(
            x, np.float64)
        _close(y, exact, tol=1e-6)

    def test_pair_view_is_automatic_only_for_huge_tables(self):
        # The byte-pair view switches on at 2**31 elements (Pallas's
        # 32-bit offsets); both views give the same result.
        op, x, y_pairs = _case(4, 32, 1, 8, "int8-pairs", False, seed=9)
        y = pk.banded_spmm(op.qblocks, x, op.scale_rows, op.diag,
                           bandwidth=1, interpret=True)
        np.testing.assert_allclose(np.asarray(y_pairs), np.asarray(y),
                                   rtol=1e-6, atol=1e-6)
        assert pk._MAX_I32_ELEMENTS == 2**31


class TestKernelArguments:
    def test_rejects_unsupported_shapes(self):
        blocks = jnp.zeros((4, 8, 24), jnp.float32)       # bs = 8 < 16
        with pytest.raises(OperatorError):
            pk.banded_spmm(blocks, jnp.zeros((32, 4), jnp.float32),
                           bandwidth=1, interpret=True)

    def test_int8_needs_scales(self):
        q = jnp.zeros((4, 32, 96), jnp.int8)
        with pytest.raises(OperatorError, match="scale_rows"):
            pk.banded_spmm(q, jnp.zeros((128, 4), jnp.float32), bandwidth=1,
                           interpret=True)

    def test_halo_row_count_checked(self):
        blocks = jnp.zeros((4, 32, 96), jnp.bfloat16)
        with pytest.raises(OperatorError, match="rows"):
            pk.banded_spmm(blocks, jnp.zeros((128, 4), jnp.float32),
                           bandwidth=1, halo=True, interpret=True)

    @pytest.mark.parametrize("bs,K,bw,dtype,ok", [
        (128, 3, 1, jnp.int8, True),
        (32, 5, 2, jnp.bfloat16, True),
        (128, 3, 1, jnp.float64, False),
        (128, 3, 1, jnp.float32, False),
        (16, 3, 1, jnp.int8, False),
        (128, 3, None, jnp.bfloat16, False),
    ])
    def test_kernel_supported(self, bs, K, bw, dtype, ok):
        assert pk.kernel_supported(bs, K, bw, dtype) is ok


class TestKernelChoice:
    @pytest.mark.parametrize("backend,platform,supported,want", [
        ("auto", "gpu", True, "compiled"),
        ("auto", "cpu", True, None),
        ("auto", "gpu", False, None),
        ("xla", "gpu", True, None),
        ("pallas", "gpu", True, "compiled"),
        ("pallas", "cpu", False, None),
        ("pallas-interpret", "cpu", True, "interpret"),
        ("pallas-interpret", "gpu", True, "interpret"),
    ])
    def test_mode(self, monkeypatch, backend, platform, supported, want):
        monkeypatch.setattr(pk.jax, "default_backend", lambda: platform)
        assert pk.kernel_mode(backend, supported) == want

    def test_compiled_kernel_off_gpu_is_a_named_error(self):
        with pytest.raises(pk.KernelUnavailableError, match="GPU"):
            pk.kernel_mode("pallas", True)

    def test_operator_with_pallas_backend_raises_on_cpu(self):
        op = generate_banded_bsr(4, 32, bandwidth=1,
                                 dtype=jnp.float32).astype(jnp.bfloat16)
        with pytest.raises(pk.KernelUnavailableError):
            op.with_backend("pallas").matmat(
                jnp.ones((op.shape[0], 2), jnp.float32))

    def test_unknown_backend(self):
        with pytest.raises(OperatorError, match="unknown backend"):
            pk.kernel_mode("mosaic", True)

    def test_quantized_default_is_auto_and_plain_on_cpu(self):
        q = quantize_banded_int8(generate_banded_bsr(
            4, 32, bandwidth=1, dtype=jnp.float32).with_backend("auto"))
        assert q.backend == "auto"
        x = jnp.ones((q.shape[0], 3), jnp.float32)
        np.testing.assert_allclose(
            np.asarray(q.matmat(x)),
            np.asarray(q.with_backend("xla").matmat(x)), rtol=0, atol=0)


class TestDeviceBudget:
    @pytest.mark.parametrize("dtype,widened", [("float64", True),
                                               ("float32", False)])
    def test_80gb_limit_widens_10m_default(self, monkeypatch, dtype,
                                           widened):
        # float64: the 80 GB limit widens the 10M/k=20 default past the
        # floor 44; float32 stays at 44, held by its measured width
        # limit (a wider f32 basis stalled at this n), not by memory.
        from fortran_davidson_tpu import config
        from fortran_davidson_tpu.config import (DavidsonOptions,
                                                 resolve_options)
        monkeypatch.delenv("FDT_CARRY_BUDGET_BYTES", raising=False)
        monkeypatch.setattr(config, "_device_bytes_limit", lambda: 80e9)
        cfg = resolve_options(DavidsonOptions(dtype=dtype,
                                              expansion="lowest-k"),
                              20, 10_000_384, generalized=False)
        assert (cfg.max_dim > 44) == widened
        assert cfg.max_dim >= 44

    def test_operator_bytes_reduce_budget(self, monkeypatch):
        from fortran_davidson_tpu import config
        monkeypatch.delenv("FDT_CARRY_BUDGET_BYTES", raising=False)
        monkeypatch.setattr(config, "_device_bytes_limit", lambda: 80e9)
        assert config.device_budget_bytes(0) == 40e9
        assert config.device_budget_bytes(20e9) == 30e9
        assert config.device_budget_bytes(100e9) == 0
        monkeypatch.setattr(config, "_device_bytes_limit", lambda: 16e9)
        assert config.device_budget_bytes(0) == 8e9

    def test_no_stats_keeps_cpu_default(self, monkeypatch):
        from fortran_davidson_tpu import config
        monkeypatch.delenv("FDT_CARRY_BUDGET_BYTES", raising=False)
        assert config._device_bytes_limit() is None   # CPU backend
        assert config.device_budget_bytes(10**9) == 12e9

    def test_operator_nbytes_counts_leaves(self):
        from fortran_davidson_tpu.config import operator_nbytes
        q = quantize_banded_int8(generate_banded_bsr(4, 32, bandwidth=1,
                                                     dtype=jnp.float32))
        want = q.qblocks.nbytes + q.scale_rows.nbytes + q.diag.nbytes
        assert operator_nbytes(q, None) == want


class TestCompileCache:
    def test_env_var_wins(self):
        from fortran_davidson_tpu.utils.compile_cache import compile_cache_dir
        env = {"JAX_COMPILATION_CACHE_DIR": "/some/cache"}
        assert compile_cache_dir(env) == "/some/cache"

    def test_default_is_fixed_checkout_path(self):
        import os

        import fortran_davidson_tpu
        from fortran_davidson_tpu.utils.compile_cache import compile_cache_dir
        root = os.path.dirname(os.path.dirname(
            os.path.abspath(fortran_davidson_tpu.__file__)))
        assert compile_cache_dir({}) == os.path.join(root, ".jax_cache")
        assert compile_cache_dir({}) == compile_cache_dir({})

    @pytest.mark.parametrize("env,sets", [("", True), ("/x", False)])
    def test_enable_sets_config_only_without_env(self, monkeypatch, env,
                                                 sets):
        from fortran_davidson_tpu.utils import compile_cache
        calls = []
        monkeypatch.setattr(jax.config, "update",
                            lambda k, v: calls.append((k, v)))
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
        path = compile_cache.enable_compile_cache()
        assert path == (env or compile_cache.CHECKOUT_CACHE_DIR)
        assert calls == ([("jax_compilation_cache_dir", path)] if sets
                         else [])


class TestBenchAndSmoke:
    @pytest.mark.parametrize("kind,part", [
        ("NVIDIA H100 80GB HBM3", "H100 SXM"),
        ("NVIDIA H100 PCIe", "H100 PCIe"),
        ("cpu", None),
    ])
    def test_peak_lookup(self, kind, part):
        import bench
        peaks = bench.device_peaks(kind)
        assert (peaks is None) == (part is None)
        if part:
            assert peaks["part"] == part and peaks["hbm_gbps"] > 0

    def test_final_line(self):
        import chip_smoke

        class Dev:
            platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"
        line = chip_smoke.final_line([Dev()])
        assert json.loads(line) == {"ok": True, "device": {
            "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
            "count": 1}}
        assert "\n" not in line

    def test_final_line_counts_devices(self):
        import chip_smoke

        class Dev:
            platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"
        assert json.loads(chip_smoke.final_line([Dev()] * 4))[
            "device"]["count"] == 4

#!/usr/bin/env python3
"""Smoke run of the Davidson solver on one NVIDIA GPU.

    python chip_smoke.py          # phases 1-5 on one card
    python chip_smoke.py --four   # the row-sharded path on four cards

Phases (one process, in order; any failure exits non-zero):

1. ``device``: the card (``nvidia-smi`` name and power limit) and JAX's
   view of it. No GPU, no run.
2. ``northstar_free``: the 10,000,384-row lowest-20 north star to 1e-8
   through ``examples.northstar`` (f32, refined, progressive), compared
   with a native float64 solve of the same operator on the card.
3. ``northstar_bsr``: lowest-20 of the int8 DIA-banded BSR north star
   (n = 2,097,152) to 1e-8 through ``eigensolve``, once with the Pallas
   kernel and once with the plain XLA apply; plus every kernel variant
   (bf16, int8, halo-extended int8) against the plain apply at full
   width, with both apply times.
4. ``f64_parity``: BASELINE configurations 1 and 2 in float64 against
   ``scipy.linalg.eigh`` and the reference-schedule oracle.
5. ``ds_identities``: the double-single error-free transforms against
   native float64 on the card.

``--four`` runs only the row-sharded int8 north star at n = 10,000,384
over four cards and the same solve on one card.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np


class PhaseFailure(AssertionError):
    """A phase's check did not hold."""


def check(cond, msg: str):
    if not cond:
        raise PhaseFailure(msg)


def final_line(devices) -> str:
    """The JSON object printed as the last line of a passing run."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def rel_diff(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


def eigenvalues64(res) -> np.ndarray:
    """Full-precision eigenvalues of a result (hi + lo words after an
    in-solve polish)."""
    vals = np.asarray(res.eigenvalues, np.float64)
    if res.eigenvalues_lo is not None:
        vals = vals + np.asarray(res.eigenvalues_lo, np.float64)
    return vals


def max_rel_residual(res) -> float:
    vals = np.abs(eigenvalues64(res))
    return float(np.max(np.asarray(res.residual_norms, np.float64)
                        / np.maximum(vals, 1.0)))


def timed(fn):
    """(result, seconds) of ``fn()``; the result is fetched to the host
    so the time covers the device work."""
    import jax
    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def cold_warm(fn):
    res, cold = timed(fn)
    res, warm = timed(fn)
    return res, cold, warm


def report(phase: str, **kv):
    items = " ".join(f"{k}={v}" for k, v in kv.items())
    print(f"[{phase}] {items}", flush=True)


# -- phase 1 -----------------------------------------------------------

def phase_device():
    import jax
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip(), flush=True)
    check(jax.default_backend() == "gpu",
          f"JAX backend is {jax.default_backend()!r}, not 'gpu'")
    devs = jax.devices()
    report("device", devices=devs, kind=repr(devs[0].device_kind),
           bytes_limit=(devs[0].memory_stats() or {}).get("bytes_limit"))


# -- phase 2 -----------------------------------------------------------

PROGRESSIVE = dict(method="DPR", relative_tolerance=True, dtype="float32",
                   expansion="lowest-k")


def phase_northstar_free(n: int = 10_000_384, k: int = 20):
    import jax.numpy as jnp

    from fortran_davidson_tpu import eigensolve
    from fortran_davidson_tpu.config import DavidsonOptions, resolve_options
    from fortran_davidson_tpu.examples import northstar
    from fortran_davidson_tpu.models.generators import surrogate_hamiltonian

    cfg = resolve_options(DavidsonOptions(dtype="float32", refined=True),
                          k, n, generalized=False)
    report("northstar_free", matmul_precision=cfg.matmul_precision,
           note="f32 products at full f32 precision, no TF32")
    out = northstar.run(["--n", str(n), "--lowest", str(k), "--progressive",
                         "--tolerance", "1e-8", "--expansion", "lowest-k"])
    r32 = out["result"]
    lam32 = eigenvalues64(r32)
    res32 = max_rel_residual(r32)
    report("northstar_free", solve="f32 refined progressive", n=n, k=k,
           cold_s=f"{out['cold_s']:.3f}", warm_s=f"{out['warm_s']:.3f}",
           iterations=int(r32.iterations), converged=bool(r32.converged),
           stalled=bool(r32.stalled), max_true_residual_rel=f"{res32:.3e}")

    op64 = surrogate_hamiltonian(n, dtype=jnp.float64)
    r64, cold, warm = cold_warm(lambda: eigensolve(
        op64, k, method="DPR", tolerance=1e-9, relative_tolerance=True,
        dtype="float64", expansion="lowest-k", max_iterations=200))
    lam64 = eigenvalues64(r64)
    report("northstar_free", solve="f64 reference", cold_s=f"{cold:.3f}",
           warm_s=f"{warm:.3f}", iterations=int(r64.iterations),
           converged=bool(r64.converged),
           max_residual_rel=f"{max_rel_residual(r64):.3e}")
    diff = rel_diff(lam32, lam64)
    report("northstar_free", max_rel_eigenvalue_diff_vs_f64=f"{diff:.3e}")
    check(bool(r32.converged), "f32 refined north star did not converge")
    check(bool(r64.converged), "f64 reference did not converge")
    check(res32 <= 1e-8, f"f32 true residual {res32:.3e} > 1e-8")
    check(diff <= 1e-8, f"f32 vs f64 eigenvalues differ by {diff:.3e}")


# -- phase 3 -----------------------------------------------------------

def _time_apply(fn, args, x, reps: int = 20) -> float:
    import jax
    jax.block_until_ready(fn(args, x))
    t0 = time.perf_counter()
    for _ in range(reps):
        y = fn(args, x)
    jax.block_until_ready(y)
    return (time.perf_counter() - t0) / reps


def _apply(op, x):
    return op.matmat(x)


def compare_apply(name, kernel, plain, args, n, widths, reps=20):
    """``kernel(args, x)`` vs ``plain(args, x)`` at each width m:
    max|Δy| <= 1e-5 max|y|, the plain one at HIGHEST precision; the
    operands are jit arguments (captured, they would be compiled in as
    constants). Returns {m: (t_kernel, t_plain)}."""
    import jax
    import jax.numpy as jnp

    times = {}
    key = jax.random.PRNGKey(7)
    fk = jax.jit(kernel)
    for m in widths:
        x = jax.random.normal(jax.random.fold_in(key, m), (n, m),
                              jnp.float32)
        with jax.default_matmul_precision("highest"):
            fp = jax.jit(plain)
            y_ref = fp(args, x)
            t_plain = _time_apply(fp, args, x, reps)
        y = fk(args, x)
        t_kernel = _time_apply(fk, args, x, reps)
        err = float(jnp.max(jnp.abs(y - y_ref)))
        scale = float(jnp.max(jnp.abs(y_ref)))
        report("northstar_bsr", apply=name, m=m,
               rel_err=f"{err / scale:.3e}",
               kernel_ms=f"{t_kernel * 1e3:.4f}",
               plain_ms=f"{t_plain * 1e3:.4f}")
        check(bool(jnp.all(jnp.isfinite(y))), f"{name} m={m}: non-finite")
        check(err <= 1e-5 * scale,
              f"{name} m={m}: max|dy| {err:.3e} > 1e-5 max|y| {scale:.3e}")
        times[m] = (t_kernel, t_plain)
    return times


def progressive_solve(op, k, solve=None, **extra):
    """Plain f32 solve to its floor warm-starting the refined+polished
    1e-8 solve (the north-star recipe). Returns both stages' results."""
    from fortran_davidson_tpu import eigensolve
    solve = solve or eigensolve
    loose = dict(PROGRESSIVE, tolerance=1e-3, max_iterations=30, **extra)
    fine = dict(loose, tolerance=1e-8, refined=True, final_polish=3,
                max_iterations=120)
    first = solve(op, k, **loose)
    return first, solve(op, k, initial_vectors=first.eigenvectors, **fine)


def worst_history(res) -> list:
    """Largest residual of each iteration (4 significant digits)."""
    hist = np.asarray(res.residual_history, np.float64)
    return [float(f"{np.nanmax(row):.4g}")
            for row in hist[:int(res.iterations)]]


def phase_northstar_bsr(nbr: int = 16384, bs: int = 128, k: int = 20,
                        widths=(20, 40, 64), small_nbr: int = 4096,
                        kernel_backend: str = "pallas"):
    import jax.numpy as jnp

    from fortran_davidson_tpu.ops.pallas_kernels import banded_spmm
    from fortran_davidson_tpu.ops.sparse import (
        _quantized_dia_apply, generate_banded_bsr,
        generate_banded_bsr_quantized)

    op_k = generate_banded_bsr_quantized(nbr, bs, bandwidth=1,
                                         backend=kernel_backend)
    op_x = op_k.with_backend("xla")
    n = op_k.shape[0]
    compare_apply("int8", lambda o, x: _apply(o[0], x),
                  lambda o, x: _apply(o[1], x), (op_k, op_x), n, widths)

    # The halo-extended form the row-sharded path runs, on one card.
    interpret = kernel_backend == "pallas-interpret"

    def halo_kernel(q, x):
        return banded_spmm(q[0], jnp.pad(x, ((bs, bs), (0, 0))), q[1], q[2],
                           bandwidth=1, halo=True, interpret=interpret)

    def halo_plain(q, x):
        return _quantized_dia_apply(q[0], q[1], q[2],
                                    jnp.pad(x, ((bs, bs), (0, 0))), 1,
                                    halo=True)
    compare_apply("int8-halo", halo_kernel, halo_plain,
                  (op_k.qblocks, op_k.scale_rows, op_k.diag), n, widths[:1])

    op16 = generate_banded_bsr(small_nbr, bs, bandwidth=1,
                               dtype=jnp.float32).astype(jnp.bfloat16)
    compare_apply("bf16", lambda o, x: _apply(o[0], x),
                  lambda o, x: _apply(o[1], x),
                  (op16.with_backend(kernel_backend),
                   op16.with_backend("xla")), op16.shape[0], widths)
    del op16

    runs = {}
    for name, op in (("kernel", op_k), ("plain", op_x)):
        (first, res), cold, warm = cold_warm(
            lambda: progressive_solve(op, k))
        runs[name] = res
        report("northstar_bsr", solve=name, n=n, k=k,
               cold_s=f"{cold:.3f}", warm_s=f"{warm:.3f}",
               plain_stage_iterations=int(first.iterations),
               iterations=int(res.iterations), converged=bool(res.converged),
               stalled=bool(res.stalled),
               max_true_residual_rel=f"{max_rel_residual(res):.3e}")
        check(bool(res.converged), f"BSR north star ({name}) did not "
              "converge")
        check(max_rel_residual(res) <= 1e-8,
              f"BSR north star ({name}) true residual above 1e-8")
    diff = rel_diff(eigenvalues64(runs["kernel"]),
                    eigenvalues64(runs["plain"]))
    report("northstar_bsr", max_rel_eigenvalue_diff_kernel_vs_plain=
           f"{diff:.3e}")
    check(diff <= 1e-8, f"kernel vs plain eigenvalues differ by {diff:.3e}")


# -- phase 4 -----------------------------------------------------------

def phase_f64_parity():
    import jax
    import scipy.linalg

    from fortran_davidson_tpu import eigensolve
    from fortran_davidson_tpu.models.generators import (
        generate_diagonal_dominant)
    from tests.reference_oracle import davidson_oracle

    cases = (
        ("config1 dense 50 DPR lowest-3", 50, "DPR", None, False),
        ("config2 generalized GJD dim 1000", 1000, "GJD", 20, True),
    )
    for name, n, method, max_dim, gen in cases:
        A = generate_diagonal_dominant(n, 1e-3, key=jax.random.PRNGKey(n))
        B = (generate_diagonal_dominant(n, 1e-3, diag_val=1.0,
                                        key=jax.random.PRNGKey(n + 1))
             if gen else None)
        res, cold, warm = cold_warm(lambda: eigensolve(
            A, 3, second_matrix=B, method=method, tolerance=1e-8,
            max_dim_sub=max_dim, max_iterations=500, dtype="float64"))
        An = np.asarray(A, np.float64)
        Bn = None if B is None else np.asarray(B, np.float64)
        exact = scipy.linalg.eigh(An, Bn, eigvals_only=True)[:3]
        _, _, iters_ref, conv_ref = davidson_oracle(
            An, 3, method=method, max_iterations=500, tol=1e-8,
            max_dim=max_dim, B=Bn)
        err = float(np.max(np.abs(np.asarray(res.eigenvalues) - exact)))
        report("f64_parity", case=repr(name), cold_s=f"{cold:.3f}",
               warm_s=f"{warm:.3f}", iterations=int(res.iterations),
               oracle_iterations=iters_ref, converged=bool(res.converged),
               max_abs_eigenvalue_err=f"{err:.3e}")
        check(res.eigenvalues.dtype == np.float64, f"{name}: not float64")
        check(bool(res.converged) and conv_ref, f"{name}: not converged")
        check(err <= 1e-10, f"{name}: eigenvalues off by {err:.3e}")
        check(abs(int(res.iterations) - iters_ref) <= 1,
              f"{name}: {int(res.iterations)} iterations vs oracle "
              f"{iters_ref}")


# -- phase 5 -----------------------------------------------------------

def phase_ds_identities(size: int = 1 << 20):
    import jax
    import jax.numpy as jnp

    from fortran_davidson_tpu.utils import ds as dsm

    key = jax.random.PRNGKey(11)
    ka, kb, kv, kw = jax.random.split(key, 4)
    # Magnitudes spread over 2^±20 so the error terms are non-trivial.
    a = (jax.random.normal(ka, (size,), jnp.float32)
         * jnp.exp2(jax.random.randint(kb, (size,), -20, 20)
                    .astype(jnp.float32)))
    b = jax.random.normal(kb, (size,), jnp.float32)

    s, e = jax.jit(dsm.two_sum)(a, b)
    a64, b64 = a.astype(jnp.float64), b.astype(jnp.float64)
    bad_sum = int(jnp.sum((s.astype(jnp.float64) + e.astype(jnp.float64))
                          != a64 + b64))
    p, q = jax.jit(dsm.two_prod)(a, b)
    bad_prod = int(jnp.sum((p.astype(jnp.float64) + q.astype(jnp.float64))
                           != a64 * b64))
    V = jax.random.normal(kv, (1 << 18, 24), jnp.float32)
    W = jax.random.normal(kw, (1 << 18, 24), jnp.float32)
    V64, W64 = V.astype(jnp.float64), W.astype(jnp.float64)
    # Dot2-quality column dots: exact products and sums, so the error is
    # eps^2-grade unless FMA contraction broke an error-free transform.
    d = jax.jit(dsm.dot_cols_ds)(V, W)
    d64 = jnp.sum(V64 * W64, axis=0)
    dot_err = float(jnp.max(jnp.abs(d.hi.astype(jnp.float64)
                                    + d.lo.astype(jnp.float64) - d64))
                    / jnp.max(jnp.abs(d64)))
    gram = gram_checks(jax.random.PRNGKey(3))
    report("ds_identities", two_sum_inexact=bad_sum,
           two_prod_inexact=bad_prod, dot_cols_ds_rel_err=f"{dot_err:.3e}",
           **{k: f"{v:.3e}" for k, v in gram.items()})
    check(bad_sum == 0, f"two_sum not error-free on {bad_sum} elements")
    check(bad_prod == 0, f"two_prod not error-free on {bad_prod} elements")
    # gram_ds sums its f32 chunk Grams with the two_sum tree: that sum
    # must be exact (eps^2-grade) ...
    check(gram["gram_ds_chunk_sum_rel_err"] <= 1e-12,
          "gram_ds across-chunk sum is not compensated")
    # ... which makes it more accurate than a plain f32 Gram where the
    # across-chunk accumulation dominates (columns with a common offset;
    # 10.6x measured on an H100 at this shape, PERF.md).
    check(5 * gram["gram_ds_rel_err_offset"]
          <= gram["plain_f32_gram_rel_err_offset"],
          "gram_ds not 5x more accurate than a plain f32 Gram on offset "
          "columns")
    check(dot_err <= 1e-12, f"dot_cols_ds error {dot_err:.3e} > 1e-12")


def gram_checks(key, n: int = 1 << 22, m: int = 24) -> dict:
    """Relative errors of ``gram_ds`` and of a plain f32 Gram against
    float64, on zero-mean columns and on columns with a common offset
    (1 + 0.1 N(0, 1)), and of gram_ds's across-chunk sum against the
    exact sum of the same f32 chunk Grams."""
    import jax
    import jax.numpy as jnp

    from fortran_davidson_tpu.utils import ds as dsm

    out = {}
    kv, kw = jax.random.split(key)
    for name, off, spread in (("random", 0.0, 1.0), ("offset", 1.0, 0.1)):
        V = off + spread * jax.random.normal(kv, (n, m), jnp.float32)
        W = off + spread * jax.random.normal(kw, (n, m), jnp.float32)
        V64, W64 = V.astype(jnp.float64), W.astype(jnp.float64)
        with jax.default_matmul_precision("highest"):
            g = jax.jit(dsm.gram_ds)(V, W)
            g64 = V64.T @ W64
            plain = (V.T @ W).astype(jnp.float64)
        scale = jnp.max(jnp.abs(g64))
        out[f"gram_ds_rel_err_{name}"] = float(jnp.max(jnp.abs(
            g.hi.astype(jnp.float64) + g.lo.astype(jnp.float64) - g64))
            / scale)
        out[f"plain_f32_gram_rel_err_{name}"] = float(
            jnp.max(jnp.abs(plain - g64)) / scale)
    c = dsm._chunk(n, None)

    def chunk_sums(V, W):
        partial = jnp.einsum("kcm,kcp->kmp", V.reshape(n // c, c, m),
                             W.reshape(n // c, c, m),
                             preferred_element_type=jnp.float32,
                             precision=jax.lax.Precision.HIGHEST)
        t = dsm.ds_sum_tree(partial, axis=0)
        return (t.hi.astype(jnp.float64) + t.lo.astype(jnp.float64),
                jnp.sum(partial.astype(jnp.float64), axis=0))
    tree, exact = jax.jit(chunk_sums)(V, W)
    out["gram_ds_chunk_sum_rel_err"] = float(
        jnp.max(jnp.abs(tree - exact)) / jnp.max(jnp.abs(exact)))
    return out


# -- --four ------------------------------------------------------------

def phase_sharded(n_devices: int = 4, nbr: int = 78_128, bs: int = 128,
                  k: int = 20, max_dim_sub: int = 44,
                  backend: str = "auto"):
    import jax

    from fortran_davidson_tpu.config import operator_nbytes
    from fortran_davidson_tpu.ops.sparse import (
        generate_banded_bsr_quantized)
    from fortran_davidson_tpu.parallel import (default_mesh,
                                               eigensolve_sharded,
                                               shard_operator)

    devs = jax.devices()
    check(len(devs) >= n_devices, f"need {n_devices} devices, "
          f"found {len(devs)}")
    mesh = default_mesh(n_devices)
    op = generate_banded_bsr_quantized(nbr, bs, bandwidth=1,
                                       backend=backend)
    n = op.shape[0]
    hq = shard_operator(op, mesh)
    shards = hq.qblocks.addressable_shards
    report("sharded", mesh=dict(mesh.shape), n=n,
           shard_rows=[s.data.shape[0] for s in shards],
           shard_devices=[str(s.device) for s in shards])
    check(len({s.device for s in shards}) == n_devices
          and all(s.data.shape[0] == nbr // n_devices for s in shards),
          "operator is not row-sharded one slab per device")

    def sharded(op_, k_, **kw):
        return eigensolve_sharded(op_, k_, mesh, **kw)

    stages_s, cold, warm = cold_warm(lambda: progressive_solve(
        hq, k, solve=sharded, max_dim_sub=max_dim_sub))
    res_s = stages_s[1]
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in devs[:n_devices]]
    report("sharded", solve=f"{n_devices} devices", cold_s=f"{cold:.3f}",
           warm_s=f"{warm:.3f}", peak_bytes_per_device=peaks)
    vec_devs = {s.device for s in res_s.eigenvectors.addressable_shards}
    check(len(vec_devs) == n_devices, "eigenvectors are not sharded")
    if all(p is not None for p in peaks):
        # Device 0 also holds the unsharded operator used below.
        others = peaks[1:]
        check(max(others) <= 1.5 * min(others)
              and peaks[0] <= 1.5 * max(others) + operator_nbytes(op),
              f"unbalanced device memory: {peaks}")

    with jax.default_device(devs[0]):
        stages_1, cold, warm = cold_warm(lambda: progressive_solve(
            op, k, max_dim_sub=max_dim_sub))
    report("sharded", solve="1 device", cold_s=f"{cold:.3f}",
           warm_s=f"{warm:.3f}")
    compare_sharded(stages_s, stages_1)


def compare_sharded(stages_s, stages_1):
    """Sharded vs one-device progressive solves, stage by stage.

    The two sides add their f32 partial sums in different orders
    (shard-local Grams and tree reductions against one device's), so
    their trajectories agree to rounding while residuals are far above
    the f32 floor and part at the floor, where the loop's exit is
    decided by which noisy iteration last improved the worst residual
    by 1% (``core.loop``: the trial polish at ``_POLISH_POLL_AT``, the
    plateau exit at ``_PLATEAU_ITERS`` non-improving iterations). So
    each stage's iteration counts must agree to within the plateau
    window, not exactly; the answer itself (flags, certified residuals,
    eigenvalues) must agree to the tolerance. Both residual histories
    are printed to show where they part.
    """
    from fortran_davidson_tpu.core.loop import _PLATEAU_ITERS

    for stage, rs, r1 in zip(("plain", "refined"), stages_s, stages_1):
        hs, h1 = worst_history(rs), worst_history(r1)
        common = min(len(hs), len(h1))
        parted = next((i for i in range(common)
                       if abs(hs[i] - h1[i]) > 1e-2 * h1[i]), None)
        report("sharded", stage=stage,
               iterations=(int(rs.iterations), int(r1.iterations)),
               converged=(bool(rs.converged), bool(r1.converged)),
               stalled=(bool(rs.stalled), bool(r1.stalled)),
               histories_part_at_iteration=parted)
        report("sharded", stage=stage, worst_residual_history_sharded=hs)
        report("sharded", stage=stage, worst_residual_history_1dev=h1)
        check(abs(int(rs.iterations) - int(r1.iterations))
              <= _PLATEAU_ITERS,
              f"{stage} stage: iterations differ by more than the "
              f"plateau window {_PLATEAU_ITERS}: sharded "
              f"{int(rs.iterations)} vs one device {int(r1.iterations)}")
    res_s, res_1 = stages_s[1], stages_1[1]
    diff = rel_diff(eigenvalues64(res_s), eigenvalues64(res_1))
    rmax = (max_rel_residual(res_s), max_rel_residual(res_1))
    report("sharded", max_true_residual_rel=[f"{r:.3e}" for r in rmax],
           max_rel_eigenvalue_diff=f"{diff:.3e}")
    check(bool(res_s.converged) == bool(res_1.converged)
          and bool(res_s.stalled) == bool(res_1.stalled),
          "converged/stalled flags differ")
    check(bool(res_s.converged) and max(rmax) <= 1e-8,
          f"not certified to 1e-8: true residuals {rmax}")
    check(diff <= 1e-8, f"sharded vs one-device eigenvalues differ by "
          f"{diff:.3e}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the row-sharded path on four cards "
                        "and its one-card comparison")
    args = parser.parse_args(argv)

    import jax
    jax.config.update("jax_enable_x64", True)

    from fortran_davidson_tpu.utils.compile_cache import enable_compile_cache
    print(f"compile cache: {enable_compile_cache()}", flush=True)

    phases = [("device", phase_device)]
    if args.four:
        phases.append(("sharded", phase_sharded))
    else:
        phases += [("northstar_free", phase_northstar_free),
                   ("northstar_bsr", phase_northstar_bsr),
                   ("f64_parity", phase_f64_parity),
                   ("ds_identities", phase_ds_identities)]
    for name, fn in phases:
        t0 = time.perf_counter()
        fn()
        print(f"[{name}] PASS ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    print(final_line(jax.devices()))
    return 0


if __name__ == "__main__":
    sys.exit(main())

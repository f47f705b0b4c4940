"""Matrix-free benchmark — the reference's ``benchmark_free`` executable.

Mirrors ``src/benchmark_free.f90:80-112``: dim-1000 generalized
matrix-free problem, lowest-3, DPR, tol 1e-8, max subspace 20; verifies
the residual norms afterwards. Unlike the reference (which has no timing
code — "benchmark" by external ``time``), this prints wall-clock for the
compile and for a warm re-solve.

Run: ``python -m fortran_davidson_tpu.examples.benchmark_free [--dim 1000]``
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dim", type=int, default=1000)
    parser.add_argument("--lowest", type=int, default=3)
    parser.add_argument("--tolerance", type=float, default=1e-8)
    parser.add_argument("--platform", default="cpu")
    args = parser.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", args.platform)
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from fortran_davidson_tpu import eigensolve
    from fortran_davidson_tpu.models.generators import (surrogate_hamiltonian,
                                                        surrogate_overlap)

    A = surrogate_hamiltonian(args.dim)
    B = surrogate_overlap(args.dim)

    def solve():
        return eigensolve(A, args.lowest, second_matrix=B, method="DPR",
                          tolerance=args.tolerance, max_iterations=1000,
                          max_dim_sub=20)

    t0 = time.perf_counter()
    res = solve()
    iters = int(res.iterations)
    print(f"cold solve (incl. compile): {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    res = solve()
    iters = int(res.iterations)
    print(f"warm solve: {time.perf_counter() - t0:.3f} s, {iters} iterations")

    print("eigenvalues:", [f"{float(v):.10f}" for v in res.eigenvalues])
    ok = True
    for j in range(args.lowest):
        v = res.eigenvectors[:, j]
        lam = float(res.eigenvalues[j])
        err = float(jnp.linalg.norm(A @ v - lam * (B @ v)))
        print(f"residual {j + 1}: {err:.3e}")
        ok = ok and err < 10 * args.tolerance
    return 0 if ok else 1


if __name__ == "__main__":
    from fortran_davidson_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    raise SystemExit(main())

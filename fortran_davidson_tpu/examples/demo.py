"""Demo driver — the reference's ``main`` executable.

Mirrors ``src/main.f90:31-75``: a dim-100 generalized problem solved with
GJD then DPR at tol 1e-5 / max subspace 10, followed by the same two
checks (eigenvalue agreement between methods; per-pair residual norms
``||A v - lambda B v||``).

Run: ``python -m fortran_davidson_tpu.examples.demo [--dim 100]``
(forces CPU float64 to match the reference's all-real64 numerics).
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dim", type=int, default=100)
    parser.add_argument("--lowest", type=int, default=3)
    parser.add_argument("--tolerance", type=float, default=1e-5)
    parser.add_argument("--platform", default="cpu",
                        help="jax platform (float64 needs cpu)")
    args = parser.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", args.platform)
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from fortran_davidson_tpu import generalized_eigensolver
    from fortran_davidson_tpu.models.generators import \
        generate_diagonal_dominant

    k = args.lowest
    mtx = generate_diagonal_dominant(args.dim, 1e-3)
    stx = generate_diagonal_dominant(args.dim, 1e-3, diag_val=1.0,
                                     key=jax.random.PRNGKey(1))

    res_gjd = generalized_eigensolver(mtx, k, method="GJD",
                                      max_iterations=100,
                                      tolerance=args.tolerance,
                                      max_dim_sub=10, second_matrix=stx)
    print(f"GJD algorithm converged in: {int(res_gjd.iterations)} iterations!")
    res_dpr = generalized_eigensolver(mtx, k, method="DPR",
                                      max_iterations=100,
                                      tolerance=args.tolerance,
                                      max_dim_sub=10, second_matrix=stx)
    print(f"DPR algorithm converged in: {int(res_dpr.iterations)} iterations!")

    print("Test 1")
    diff = float(jnp.linalg.norm(res_gjd.eigenvalues - res_dpr.eigenvalues))
    print("Check that eigenvalues norm computed by different methods are "
          f"the same: {diff < 1e-6}")

    print("Test 2")
    print("Check that eigenvalue equation:  H V = l S V  holds!")
    ok = True
    for name, res in (("DPR", res_dpr), ("GJD", res_gjd)):
        print(f"{name} method:")
        for j in range(k):
            v = res.eigenvectors[:, j]
            lam = float(res.eigenvalues[j])
            err = float(jnp.linalg.norm(mtx @ v - lam * (stx @ v)))
            print(f"eigenvalue {j + 1}: {lam:.12f}  ||Error||: {err:.3e}")
            ok = ok and err < 10 * args.tolerance
    return 0 if (ok and diff < 1e-6) else 1


if __name__ == "__main__":
    from fortran_davidson_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    raise SystemExit(main())

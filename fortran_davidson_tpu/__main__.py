"""Command-line driver: ``python -m fortran_davidson_tpu <command>``.

The reference ships compiled driver programs (``src/main.f90`` demo,
``src/benchmark_free.f90``); this CLI is their production-shaped
equivalent plus a general ``solve`` command over on-disk matrices.

Commands:
  solve       lowest-k eigenpairs of a matrix file (.npy/.npz/.txt)
  demo        the reference's dim-100 generalized GJD-vs-DPR demo
  benchmark   the reference's dim-1000 matrix-free benchmark (timed)
  northstar   the 10M-row single-device benchmark driver

``solve`` accepts whitespace-text matrices (the reference's interchange
format, ``utils.io``), ``.npy`` dense arrays, or ``.npz`` files with
either a dense ``matrix`` entry or scipy-sparse CSR members (``data`` /
``indices`` / ``indptr`` / ``shape``) — sparse inputs route through the
hybrid band+remainder operator path.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _load_operator(path: str, dtype):
    import jax.numpy as jnp

    from fortran_davidson_tpu.ops.operators import as_operator
    from fortran_davidson_tpu.utils.dtypes import canonical_dtype

    dtype = canonical_dtype(dtype)  # enables x64 lazily for float64

    if path.endswith(".npy"):
        arr = np.load(path)
    elif path.endswith(".npz"):
        with np.load(path) as z:
            if "matrix" in z:
                arr = z["matrix"]
            elif {"data", "indices", "indptr", "shape"} <= set(z.files):
                import scipy.sparse as sp
                csr = sp.csr_matrix(
                    (z["data"], z["indices"], z["indptr"]),
                    shape=tuple(z["shape"]))
                return as_operator(csr, dtype=jnp.dtype(dtype))
            else:
                raise SystemExit(
                    f"{path}: .npz needs a 'matrix' entry or scipy CSR "
                    f"members (data/indices/indptr/shape); found "
                    f"{sorted(z.files)}")
    else:
        from fortran_davidson_tpu.utils.io import read_matrix
        arr = read_matrix(path)
    return as_operator(jnp.asarray(arr, jnp.dtype(dtype)))


def _cmd_solve(args) -> int:
    if args.platform:
        # Must precede any jax operation.
        import jax
        jax.config.update("jax_platforms", args.platform)
    from fortran_davidson_tpu import eigensolve

    A = _load_operator(args.matrix, args.dtype)
    B = (_load_operator(args.second_matrix, args.dtype)
         if args.second_matrix else None)
    kw = dict(method=args.method, tolerance=args.tolerance,
              max_iterations=args.max_iterations, dtype=args.dtype,
              relative_tolerance=args.relative_tolerance,
              refined=args.refined, final_polish=args.final_polish,
              gjd_warm_start=args.gjd_warm_start)
    if args.refined and not args.sharded:
        kw["carry_layout"] = args.carry_layout
    if args.initial_vectors:
        kw["initial_vectors"] = np.load(args.initial_vectors)
    if args.max_dim_sub:
        kw["max_dim_sub"] = args.max_dim_sub
    if args.sharded:
        import jax

        from fortran_davidson_tpu.parallel import (default_mesh,
                                                   eigensolve_sharded)
        mesh = default_mesh(len(jax.devices()))
        res = eigensolve_sharded(A, args.lowest, mesh,
                                 second_matrix=B, **kw)
    else:
        res = eigensolve(A, args.lowest, second_matrix=B, **kw)
    res.block_until_ready()

    out = {
        "eigenvalues": [float(v) for v in np.asarray(res.eigenvalues)],
        "residual_norms": [float(v)
                           for v in np.asarray(res.residual_norms)],
        "iterations": int(res.iterations),
        "converged": bool(res.converged),
        "stalled": (bool(res.stalled)
                    if res.stalled is not None else None),
        "operator_columns": int(res.operator_columns),
    }
    print(json.dumps(out))
    if args.eigenvectors:
        np.save(args.eigenvectors, np.asarray(res.eigenvectors))
        print(f"eigenvectors -> {args.eigenvectors}", file=sys.stderr)
    return 0 if bool(res.converged) else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m fortran_davidson_tpu",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    ps = sub.add_parser("solve", help="lowest-k eigenpairs of a matrix file")
    ps.add_argument("matrix", help=".npy / .npz / whitespace-text matrix")
    ps.add_argument("--lowest", "-k", type=int, default=3)
    ps.add_argument("--second-matrix", help="operator B (generalized)")
    ps.add_argument("--method", default="DPR",
                    choices=["DPR", "GJD", "OLSEN"])
    ps.add_argument("--gjd-warm-start", action="store_true",
                    help="recycle each outer iteration's GJD correction "
                    "as the next inner solve's initial guess (GJD only)")
    ps.add_argument("--tolerance", type=float, default=1e-8)
    ps.add_argument("--relative-tolerance", action="store_true")
    ps.add_argument("--max-iterations", type=int, default=1000)
    ps.add_argument("--max-dim-sub", type=int, default=0)
    ps.add_argument("--dtype", default="float64",
                    choices=["float64", "float32"])
    ps.add_argument("--refined", action="store_true",
                    help="double-single high-precision path (f32)")
    ps.add_argument("--final-polish", type=int, default=0,
                    metavar="ITERS",
                    help="in-solve eigenpair polish (requires --refined)")
    ps.add_argument("--carry-layout", choices=["auto", "flat", "chunked"],
                    default="auto",
                    help="refined-path carry storage; 'chunked' removes "
                    "the per-iteration relayout copies (single-chip "
                    "only, requires --refined)")
    ps.add_argument("--sharded", action="store_true",
                    help="row-shard over all visible devices")
    ps.add_argument("--eigenvectors", metavar="OUT.npy",
                    help="save eigenvectors to this .npy file")
    ps.add_argument("--platform", choices=["cpu", "gpu"],
                    help="force a jax platform")
    ps.add_argument("--initial-vectors", metavar="X0.npy",
                    help="warm-start block from a previous solve "
                    "(see --eigenvectors)")

    for name, mod in [("demo", "demo"), ("benchmark", "benchmark_free"),
                      ("northstar", "northstar")]:
        p = sub.add_parser(name, add_help=False,
                           help=f"run examples.{mod} (args passed through)")
        p.add_argument("rest", nargs=argparse.REMAINDER)

    args = parser.parse_args(argv)
    if args.command == "solve":
        return _cmd_solve(args)
    import importlib
    mod = {"demo": "demo", "benchmark": "benchmark_free",
           "northstar": "northstar"}[args.command]
    m = importlib.import_module(f"fortran_davidson_tpu.examples.{mod}")
    return m.main(args.rest)


if __name__ == "__main__":
    from fortran_davidson_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    raise SystemExit(main())

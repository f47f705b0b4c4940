"""Dtype policy for the Davidson framework.

The reference library computes everything in ``real64`` (``dp`` kind,
reference ``src/numeric_kinds.f90:10``). float64 moves twice the bytes of
float32 and runs far slower on some accelerators; the framework therefore
supports a configurable dtype policy:

- ``float64`` (default): bitwise-compatible semantics with the reference,
  required for the 1e-8 convergence parity tests. Requires ``jax_enable_x64``.
- ``float32``: fast path for throughput benchmarks and looser tolerances.
- mixed: the solver always performs the *small* subspace math (projected
  eigenproblem, Gram matrices) in ``solve_dtype`` while the large operator
  applications run in ``apply_dtype``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_X64_ENABLED = False


def ensure_x64() -> None:
    """Enable 64-bit mode in JAX (idempotent).

    The reference is an all-float64 library; we enable x64 lazily the first
    time a float64 computation is requested rather than at import time, so
    float32-only users keep default JAX semantics until they opt in.
    """
    global _X64_ENABLED
    if not _X64_ENABLED:
        jax.config.update("jax_enable_x64", True)
        _X64_ENABLED = True


def canonical_dtype(dtype) -> jnp.dtype:
    """Normalize a user-supplied dtype, enabling x64 when needed."""
    dt = jnp.dtype(dtype)
    if dt in (jnp.dtype(jnp.float64),):
        ensure_x64()
    if dt not in (jnp.dtype(jnp.float32), jnp.dtype(jnp.float64)):
        raise ValueError(
            f"Unsupported dtype {dt}; the Davidson solver supports float32 and "
            "float64 (bfloat16 is used internally by kernels only)."
        )
    return dt


def eps(dtype) -> float:
    return float(jnp.finfo(dtype).eps)


def safe_denominator(d, dtype=None, floor_scale: float = 1e2):
    """Clamp near-zero denominators away from zero, preserving sign.

    The reference divides by ``lambda_j - A_ii`` unguarded
    (``src/davidson.f90:691-693``), which can produce inf/NaN when a Ritz
    value collides with a diagonal entry. Under jit we clamp instead:
    values with magnitude below ``floor_scale * eps * max|d|`` are replaced
    by that floor with the original sign (sign(0) treated as +).
    """
    dt = d.dtype if dtype is None else dtype
    scale = jnp.max(jnp.abs(d))
    floor = floor_scale * eps(dt) * jnp.maximum(scale, jnp.asarray(1.0, dt))
    mag = jnp.maximum(jnp.abs(d), floor)
    sign = jnp.where(d < 0, -1.0, 1.0).astype(dt)
    return sign * mag

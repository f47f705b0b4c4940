"""Row-sharded (multi-chip) Davidson solves.

The scaling design follows the standard JAX recipe (pick a mesh, annotate
shardings, let XLA insert the collectives) rather than any explicit
message-passing runtime — the reference has no distributed layer at all
(single process + OpenMP, ``src/davidson.f90:559-567``), so this is where
this framework goes beyond it:

- the operator's row dimension and the tall arrays ``V``/``AV``/``BV``
  (shape ``(n, m_max)``) are sharded across the ``"rows"`` mesh axis;
- Gram products ``V^T (A V)`` contract over the sharded dimension — GSPMD
  lowers them to local matmuls + a ``psum`` (the analogue of the
  reference's ``lapack_matmul('T','N',...)`` at ``src/davidson.f90:131``);
- the tiny projected eigenproblem stays replicated on every device;
- DPR corrections, residuals, and basis updates are purely row-local.

:class:`RowShardConstraint` pins these layouts at every loop iteration so
GSPMD's fixed-point propagation can never silently replicate the tall
arrays; it is hashable and keys the compiled-engine cache.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fortran_davidson_tpu.config import (DavidsonOptions, DavidsonResult,
                                         validate_initial_vectors,
                                         merge_options, operator_nbytes,
                                         resolve_options)
from fortran_davidson_tpu.core.loop import get_engine
from fortran_davidson_tpu.ops.operators import (DenseOperator,
                                                DiagonalOperator,
                                                LinearOperator,
                                                MatrixFreeOperator,
                                                as_operator)
from fortran_davidson_tpu.ops.sparse import (BSROperator, ELLOperator,
                                             HybridBandedOperator,
                                             SlicedELLOperator,
                                             QuantizedBandedOperator)
from fortran_davidson_tpu.parallel.mesh import ROWS_AXIS, row_sharding
from fortran_davidson_tpu.utils.dtypes import canonical_dtype
from fortran_davidson_tpu.utils.errors import OperatorError, require

_SHARDED_STATE_KEYS = ("V", "AV", "BV", "evecs", "corr_prev")


@dataclasses.dataclass(frozen=True)
class RowShardConstraint:
    """Hashable state hook: pin row-sharded layouts on the tall loop state.

    Rank-aware: flat carries are ``(n, m)``; chunked carries are
    ``(n/c, c, m)`` with the leading axis still the (chunk-granular) row
    axis — both get ``P(rows, None, ...)``.
    """

    mesh: Mesh
    axis: str = ROWS_AXIS

    @property
    def row_divisor(self) -> int:
        """Device count along the row axis (chunked carries size their
        chunks to divide the per-shard row count — see core.loop)."""
        return int(self.mesh.shape[self.axis])

    def __call__(self, state: dict) -> dict:
        out = dict(state)
        for key in _SHARDED_STATE_KEYS:
            if key in out:
                arr = out[key]
                sh = NamedSharding(
                    self.mesh, P(self.axis, *([None] * (arr.ndim - 1))))
                out[key] = jax.lax.with_sharding_constraint(arr, sh)
        return out


def shard_operator(op: LinearOperator, mesh: Mesh,
                   axis: str = ROWS_AXIS) -> LinearOperator:
    """Place an operator's arrays row-sharded on ``mesh``.

    Every supported operator kind has a natural row partition:

    - dense: matrix rows; - diagonal: the diagonal vector;
    - ELL: per-row index/value tables (gathers of the input block become
      an all-gather of the skinny ``(n, m)`` block — cheap relative to
      the row-local flops);
    - BSR: block-row tables;
    - hybrid band+remainder: band via the BSR path, remainder via the ELL
      path (both row partitions line up, so the sum stays shard-local up
      to the remainder's gather);
    - int8 quantized banded: promoted to :class:`HaloQuantizedOperator`
      (blocks/scales/diagonal row-sharded, ring ppermute halos, int8
      Pallas kernel per shard);
    - matrix-free: every captured array whose leading dimension is ``n``
      (the callable itself must be shard-oblivious, i.e. expressed in
      global-view jnp ops).

    Operators that already own their placement (``HaloBSROperator``) pass
    through untouched. Any other kind raises ``OperatorError`` — silently
    running with an unsharded operator would defeat the point of
    :func:`eigensolve_sharded` without any visible signal.
    """
    from fortran_davidson_tpu.parallel.halo import (HaloBSROperator,
                                                    HaloQuantizedOperator)

    n = op.shape[0]
    ndev = mesh.shape[axis]
    if isinstance(op, (BSROperator, QuantizedBandedOperator)):
        nbr = op.n_block_rows
        require(nbr % ndev == 0, OperatorError,
                f"{nbr} block rows not divisible by the {ndev}-device mesh; "
                f"build the operator with block_rows_multiple={ndev} "
                "(split_band_remainder) or pad the block rows")
    elif not isinstance(op, (HaloBSROperator, HaloQuantizedOperator)):
        require(n % ndev == 0, OperatorError,
                f"operator dimension {n} not divisible by the {ndev}-device "
                f"mesh; pad n to a multiple of {ndev}")

    def put(arr, ndim=None):
        return jax.device_put(arr, row_sharding(mesh, arr.ndim, axis))

    if isinstance(op, DenseOperator):
        return DenseOperator(put(op.matrix))
    if isinstance(op, DiagonalOperator):
        return DiagonalOperator(put(op.diag))
    if isinstance(op, ELLOperator):
        return ELLOperator(put(op.indices), put(op.values), chunk=op.chunk)
    if isinstance(op, SlicedELLOperator):
        # The sliced layout's unsort gather crosses shards; the uniform
        # (n, L) table row-shards with no output movement — convert.
        ell = op.to_ell()
        return ELLOperator(put(ell.indices), put(ell.values),
                           chunk=ell.chunk)
    if isinstance(op, HybridBandedOperator):
        band = shard_operator(op.band, mesh, axis)
        rem = (None if op.remainder is None
               else shard_operator(op.remainder, mesh, axis))
        return HybridBandedOperator(band, rem, perm=op.perm)
    if isinstance(op, BSROperator):
        return BSROperator(put(op.block_cols), put(op.blocks),
                           backend=op.backend, bandwidth=op.bandwidth)
    if isinstance(op, MatrixFreeOperator):
        captured = tuple(
            put(c) if getattr(c, "ndim", 0) >= 1 and c.shape[0] == n else c
            for c in op.captured)
        diag = None if op.diag is None else put(op.diag)
        return MatrixFreeOperator(op.fn, n, dtype=op.dtype, diag=diag,
                                  captured=captured)
    if isinstance(op, QuantizedBandedOperator):
        # Quantized banded -> halo form: int8 blocks + scales + diagonal
        # row-sharded, ring ppermute halo exchange, int8 Pallas kernel.
        return HaloQuantizedOperator.from_quantized(op, mesh, axis)
    if isinstance(op, (HaloBSROperator, HaloQuantizedOperator)):
        return op  # owns its placement (shard_map + ppermute inside)
    raise OperatorError(
        f"shard_operator: no sharding rule for {type(op).__name__}; "
        "refusing to run eigensolve_sharded with an unsharded operator")


def eigensolve_sharded(matrix, lowest: int, mesh: Mesh, second_matrix=None,
                       axis: str = ROWS_AXIS,
                       options: Optional[DavidsonOptions] = None,
                       initial_vectors=None,
                       **overrides) -> DavidsonResult:
    """Row-sharded multi-chip Davidson solve.

    Same contract as :func:`fortran_davidson_tpu.solver.eigensolve`
    (including ``initial_vectors`` warm starts — the block is placed
    row-sharded like the basis), with the operator and the solver's tall
    state distributed over ``mesh``.
    """
    opts = merge_options(options, overrides)
    dt = canonical_dtype(opts.dtype)

    A = shard_operator(as_operator(matrix, dtype=dt), mesh, axis)
    B = (None if second_matrix is None
         else shard_operator(as_operator(second_matrix, dtype=dt), mesh, axis))
    require(A.shape[0] == A.shape[1], OperatorError, "A must be square")
    if B is not None:
        require(B.shape == A.shape, OperatorError,
                f"B shape {B.shape} does not match A shape {A.shape}")

    cfg = resolve_options(opts, lowest, A.shape[0], generalized=B is not None,
                          sharded=True,
                          shard_row_divisor=int(mesh.shape[axis]),
                          operator_bytes=(operator_nbytes(A, B)
                                          // int(mesh.shape[axis])))
    X0 = validate_initial_vectors(initial_vectors, A.shape[0],
                                  cfg.init_dim, dt)
    if X0 is not None:
        X0 = jax.device_put(X0, NamedSharding(mesh, P(axis, None)))
    engine = get_engine(cfg, constrain=RowShardConstraint(mesh, axis))
    with mesh:
        if cfg.refined:
            # The refined path needs the off-diagonal splits (compensated
            # true residuals; see solver.eigensolve). The splits derive
            # from the already-sharded operator arrays, so their row
            # placement carries over.
            return engine(A, B, A.offdiag(),
                          B.offdiag() if B is not None else None, X0=X0)
        return engine(A, B, X0=X0)

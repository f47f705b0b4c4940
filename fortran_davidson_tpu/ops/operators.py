"""Linear-operator layer.

The reference exposes exactly two operator kinds through a compile-time
generic interface (dense matrix vs. block-gemv callable,
reference ``src/davidson.f90:601-625``). This framework replaces
that with a small ``LinearOperator`` protocol: every operator is a pytree
(so it can flow through ``jit``/``shard_map``) that knows how to

- apply itself to a *block* of vectors (``matmat``; (n, m) -> (n, m)) —
  block application is the only primitive the solver ever uses, keeping the
  FLOPs in batched matmuls rather than per-column gemvs
  (the reference's dense path does one DGEMV per column per iteration,
  ``src/davidson.f90:163-170``), and
- produce its diagonal (``diagonal``), needed by the DPR preconditioner
  and the initial-subspace selection.

Concrete operators: :class:`DenseOperator`, :class:`DiagonalOperator`,
:class:`MatrixFreeOperator` (user callable + known diagonal), plus the
sparse operators in :mod:`fortran_davidson_tpu.ops.sparse`.
"""

from __future__ import annotations

import abc
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from fortran_davidson_tpu.utils.errors import OperatorError, require


class LinearOperator(abc.ABC):
    """A symmetric linear operator on R^n, applied to blocks of vectors."""

    @property
    @abc.abstractmethod
    def shape(self) -> tuple:
        """(n, n)."""

    @property
    @abc.abstractmethod
    def dtype(self):
        ...

    @abc.abstractmethod
    def matmat(self, block):
        """Apply to a block: (n, m) -> (n, m)."""

    @abc.abstractmethod
    def diagonal(self):
        """Return the n-vector of diagonal entries."""

    # ------------------------------------------------------------------
    def offdiag(self) -> "LinearOperator":
        """The operator minus its diagonal, as a new operator.

        The high-precision (refined) solver path evaluates residuals as
        ``r = A_off @ x + ds((d - λ)·x)`` — for diagonal-dominant
        operators the entire f32 cancellation error lives in the diagonal
        term, which double-single elementwise arithmetic computes to
        ~eps^2 (see ``utils.ds.shifted_diag_apply``). Exact structural
        overrides (sparse formats zero their stored diagonal entries) have
        no error floor; this generic fallback computes
        ``matmat(x) - diagonal()·x`` and therefore retains the operator
        apply's own ~eps·|d_i x_i| rounding — still far below the naive
        ~sqrt(n)·eps floor, but not exact.
        """
        return SubtractDiagOperator(self)

    def matmat_ds(self, x_hi, x_lo):
        """Optional double-single block apply: ``(y_hi, y_lo)`` with
        ``y_hi + y_lo ≈ A @ (x_hi + x_lo)`` to ~eps².

        A plain f32 ``matmat`` floors ANY residual measurement at the
        elementwise rounding of its own output (~eps/2·‖A_off x‖ in
        norm — at the 10M-row north star that is ~1.4e-8, right at the
        1e-8 contract). Operators whose structure admits a compensated
        evaluation (e.g. low-rank couplings with DS grams) override
        this; ``None`` (the default) means unsupported and callers fall
        back to the single-array apply.
        """
        return None

    def matvec(self, vec):
        """Apply to a single vector (thin wrapper over block apply)."""
        return self.matmat(vec[:, None])[:, 0]

    def __matmul__(self, other):
        if getattr(other, "ndim", None) == 1:
            return self.matvec(other)
        return self.matmat(other)

    @property
    def n(self) -> int:
        return self.shape[0]


@jax.tree_util.register_pytree_node_class
class SubtractDiagOperator(LinearOperator):
    """Generic off-diagonal wrapper: ``A_off @ x = A @ x - d ∘ x``.

    Fallback for operators without a structural diagonal split (see
    :meth:`LinearOperator.offdiag`); carries the base apply's
    ~eps·|d_i x_i| rounding in the diagonal term.
    """

    def __init__(self, base: LinearOperator):
        self.base = base
        self._diag = base.diagonal()

    @property
    def shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return self.base.dtype

    def matmat(self, block):
        return self.base.matmat(block) - self._diag[:, None] * block

    def diagonal(self):
        return jnp.zeros_like(self._diag)

    def tree_flatten(self):
        return (self.base, self._diag), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.base, obj._diag = children
        return obj


@jax.tree_util.register_pytree_node_class
class DenseOperator(LinearOperator):
    """Operator backed by an in-memory dense symmetric matrix.

    Replaces the reference's dense engine input
    (``src/davidson.f90:51-75``); block application is a single matmul.
    """

    def __init__(self, matrix):
        matrix = jnp.asarray(matrix)
        require(matrix.ndim == 2 and matrix.shape[0] == matrix.shape[1],
                OperatorError, f"DenseOperator needs a square matrix, got {matrix.shape}")
        self.matrix = matrix

    @property
    def shape(self):
        return self.matrix.shape

    @property
    def dtype(self):
        return self.matrix.dtype

    def matmat(self, block):
        return jnp.dot(self.matrix, block, preferred_element_type=self.dtype)

    def diagonal(self):
        return jnp.diagonal(self.matrix)

    def offdiag(self):
        n = self.matrix.shape[0]
        eye = jnp.eye(n, dtype=bool)
        return DenseOperator(jnp.where(eye, 0, self.matrix))

    def to_dense(self):
        return self.matrix

    def tree_flatten(self):
        return (self.matrix,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.matrix = children[0]
        return obj


@jax.tree_util.register_pytree_node_class
class DiagonalOperator(LinearOperator):
    """Operator backed by a diagonal (the cheapest useful B for pencils)."""

    def __init__(self, diag):
        diag = jnp.asarray(diag)
        require(diag.ndim == 1, OperatorError, "DiagonalOperator needs a 1-D diagonal")
        self.diag = diag

    @property
    def shape(self):
        return (self.diag.shape[0], self.diag.shape[0])

    @property
    def dtype(self):
        return self.diag.dtype

    def matmat(self, block):
        return self.diag[:, None] * block

    def diagonal(self):
        return self.diag

    def offdiag(self):
        return DiagonalOperator(jnp.zeros_like(self.diag))

    def to_dense(self):
        return jnp.diag(self.diag)

    def tree_flatten(self):
        return (self.diag,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.diag = children[0]
        return obj


@jax.tree_util.register_pytree_node_class
class MatrixFreeOperator(LinearOperator):
    """Operator defined by a block-gemv callable ``fn(X: (n, m)) -> (n, m)``.

    Mirrors the reference matrix-free engine input
    (``src/davidson.f90:277-337``) with two deliberate upgrades:

    - the diagonal should be supplied up front (``diag=``). The reference
      extracts it with n single-unit-vector probes — n full operator
      applications (``src/davidson.f90:490-523``). When ``diag`` is omitted
      we fall back to *blocked* probing (:func:`probe_diagonal`), which
      costs ``ceil(n / block)`` block applications instead of ``n``.
    - the callable receives a block, never a single column, so the user's
      implementation can be a fused SpMM/einsum.

    ``fn`` is static (part of the pytree structure); closures over arrays
    should instead capture them via ``captured`` so they are traced.
    """

    def __init__(self, fn: Callable, n: int, dtype=jnp.float64,
                 diag=None, captured=(), offdiag_fn: Optional[Callable] = None,
                 ds_fn: Optional[Callable] = None,
                 offdiag_ds_fn: Optional[Callable] = None):
        self.fn = fn
        self._n = int(n)
        self._dtype = jnp.dtype(dtype)
        self.diag = None if diag is None else jnp.asarray(diag)
        self.captured = tuple(captured)
        # Optional exact off-diagonal apply (same signature as fn) for the
        # refined/high-precision path; without it offdiag() falls back to
        # the generic matmat - diag·x wrapper.
        self.offdiag_fn = offdiag_fn
        # Optional double-single applies (see LinearOperator.matmat_ds):
        # ds_fn(x_hi, x_lo, *captured) -> (y_hi, y_lo) for THIS operator;
        # offdiag_ds_fn becomes the ds_fn of the offdiag() operator.
        self.ds_fn = ds_fn
        self.offdiag_ds_fn = offdiag_ds_fn

    @property
    def shape(self):
        return (self._n, self._n)

    @property
    def dtype(self):
        return self._dtype

    def matmat(self, block):
        if self.captured:
            return self.fn(block, *self.captured)
        return self.fn(block)

    def diagonal(self):
        if self.diag is not None:
            return self.diag
        return probe_diagonal(self.matmat, self._n, self._dtype)

    def matmat_ds(self, x_hi, x_lo):
        if self.ds_fn is None:
            return None
        return self.ds_fn(x_hi, x_lo, *self.captured)

    def offdiag(self):
        if self.offdiag_fn is None:
            return super().offdiag()
        return MatrixFreeOperator(self.offdiag_fn, self._n,
                                  dtype=self._dtype,
                                  diag=jnp.zeros((self._n,), self._dtype),
                                  captured=self.captured,
                                  ds_fn=self.offdiag_ds_fn)

    def tree_flatten(self):
        return ((self.diag, self.captured),
                (self.fn, self._n, self._dtype, self.offdiag_fn,
                 self.ds_fn, self.offdiag_ds_fn))

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.diag, obj.captured = children
        (obj.fn, obj._n, obj._dtype, obj.offdiag_fn,
         obj.ds_fn, obj.offdiag_ds_fn) = aux
        return obj


def probe_diagonal(matmat: Callable, n: int, dtype, block: int = 128):
    """Extract the diagonal of an implicit operator with blocked probes.

    Debug fallback for operators without a known diagonal: apply the
    operator to blocks of canonical unit vectors and read off the matching
    rows. ceil(n/block) block applications — compare the reference's n
    single-vector applications (``src/davidson.f90:516-521``).
    """
    block = min(block, n)
    nblocks = -(-n // block)
    npad = nblocks * block
    eye_block = jnp.eye(block, dtype=dtype)

    def body(i, diag):
        start = i * block
        probes = jnp.zeros((n, block), dtype)
        probes = jax.lax.dynamic_update_slice(
            probes, eye_block[: min(block, n), :], (start, 0))
        out = matmat(probes)  # (n, block)
        seg = jax.lax.dynamic_slice(out, (start, 0), (block, block))
        vals = jnp.diagonal(seg)
        return jax.lax.dynamic_update_slice(diag, vals, (start,))

    diag = jnp.zeros((npad,), dtype)
    if npad > n:
        # Clamped dynamic slices near the edge would mis-align probes; pad
        # the index space by running the last block at offset n - block.
        def body_clamped(i, diag):
            start = jnp.minimum(i * block, n - block)
            probes = jnp.zeros((n, block), dtype)
            probes = jax.lax.dynamic_update_slice(probes, eye_block, (start, 0))
            out = matmat(probes)
            seg = jax.lax.dynamic_slice(out, (start, 0), (block, block))
            vals = jnp.diagonal(seg)
            return jax.lax.dynamic_update_slice(diag, vals, (start,))
        diag = jax.lax.fori_loop(0, nblocks, body_clamped, diag)
    else:
        diag = jax.lax.fori_loop(0, nblocks, body, diag)
    return diag[:n]


def from_element_fn(fn: Callable, n: int, dtype=jnp.float64,
                    diag=None, row_block: int = 256) -> MatrixFreeOperator:
    """Operator defined by an element function ``fn(i, j) -> A_ij``.

    Counterpart of the reference's ``free_matmul``
    (``src/davidson.f90:526-569``), which regenerates matrix rows on the
    fly from a column function and dot-products them against the basis
    inside an OpenMP loop. Here rows are generated in blocks with a
    double ``vmap`` and contracted against the input block:
    ``A @ X`` costs ``ceil(n / row_block)`` dense ``(row_block, n) @
    (n, m)`` matmuls with O(row_block * n) transient memory.

    ``fn`` must accept traced integer scalars (i, j) and return a scalar.
    If ``diag`` is omitted it is computed once from ``fn`` directly.
    """
    dt = jnp.dtype(dtype)
    cols = jnp.arange(n)
    row_of = jax.vmap(lambda i: jax.vmap(lambda j: fn(i, j))(cols))
    if diag is None:
        diag = jax.vmap(lambda i: fn(i, i))(cols).astype(dt)

    nblocks = -(-n // row_block)
    npad = nblocks * row_block

    def apply(X, diag):
        m = X.shape[1]

        def body(b, out):
            start = b * row_block
            rows_idx = start + jnp.arange(row_block)
            rows = row_of(jnp.minimum(rows_idx, n - 1)).astype(X.dtype)
            seg = jnp.dot(rows, X, preferred_element_type=X.dtype)
            return jax.lax.dynamic_update_slice(out, seg, (start, 0))

        out = jax.lax.fori_loop(0, nblocks, body,
                                jnp.zeros((npad, m), X.dtype))
        return out[:n]

    return MatrixFreeOperator(apply, n, dtype=dt, diag=diag,
                              captured=(diag,))


def as_operator(obj, dtype=None) -> LinearOperator:
    """Coerce user input (operator / dense array) to a LinearOperator.

    The compile-time overload resolution of the reference's generic
    interface (``src/davidson.f90:601-625``) becomes a plain type switch.
    """
    if isinstance(obj, LinearOperator):
        return obj
    # scipy.sparse ingestion (duck-typed so scipy stays optional): CSR/CSC/
    # COO matrices become padded-ELL operators.
    if hasattr(obj, "tocsr") and hasattr(obj, "shape"):
        from fortran_davidson_tpu.ops.sparse import ELLOperator
        csr = obj.tocsr()
        return ELLOperator.from_csr(csr.indptr, csr.indices, csr.data,
                                    dtype=dtype or csr.dtype)
    arr = jnp.asarray(obj, dtype=dtype)
    if arr.ndim == 2:
        return DenseOperator(arr)
    if arr.ndim == 1:
        return DiagonalOperator(arr)
    raise OperatorError(
        f"Cannot interpret object of type {type(obj)} with ndim "
        f"{getattr(arr, 'ndim', None)} as a linear operator")

"""Sparse operators in accelerator-friendly layouts.

The reference has no sparse formats at all — its only "large operator"
story is the matrix-free callable that regenerates full rows on the fly
(``src/davidson.f90:526-569``). An accelerator solver needs real sparse
storage, but classic CSR (variable-length rows, data-dependent loop trip
counts) is hostile to XLA's static-shape compilation model. We therefore
use two *padded, fixed-shape* layouts:

- **ELL** (``ELLOperator``): every row stores exactly ``L`` (column, value)
  slots, padded with ``value = 0`` pointing at the row's own index. The
  SpMM is a chunked gather + einsum — dense, static-shape work, with the
  chunk size bounding peak memory. This is the CSR equivalent for
  unstructured ~k-nnz/row matrices (BASELINE config 3). Unstructured row
  gathers run far below the streaming roofline; matrices with *any*
  structure should use :class:`BSROperator` (banded storage, contiguous
  reads) or a matrix-free operator. Unstructured ELL is the portability
  fallback, not the performance path.
- **BSR** (``BSROperator``): block rows store exactly ``K`` dense
  ``bs x bs`` blocks (block-ELL). The SpMM gathers ``bs x m`` slices of
  the input block and contracts them against the stored blocks in one
  batched einsum. This is the format for the 10M-row north-star workload
  and the row-sharded distributed path. DIA-banded storage can take the
  Pallas kernel of ``fortran_davidson_tpu.ops.pallas_kernels`` (compiled
  through Triton on a GPU), which reads each stored block once.

Both operators are pytrees, so they flow through ``jit`` / ``shard_map``
unchanged. Constructors do their index surgery host-side in numpy — that
is one-time setup, not solver work.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from fortran_davidson_tpu.ops.operators import LinearOperator
from fortran_davidson_tpu.ops.pallas_kernels import (BACKENDS, banded_spmm,
                                                     kernel_mode,
                                                     kernel_supported)
from fortran_davidson_tpu.utils.errors import OperatorError, require


def _coo_dedup_np(rows, cols, vals, n):
    """Host-side COO canonicalization: range check, row-major sort,
    duplicate summing. Shared by the padded-ELL and sliced-ELL builders."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    # Same index contract as the native C++ assembler: out-of-range
    # indices raise instead of folding into a neighboring row/column.
    if len(rows) and not (rows.min() >= 0 and cols.min() >= 0
                          and rows.max() < n and cols.max() < n):
        raise OperatorError(
            f"COO indices out of range [0, {n}): rows in "
            f"[{rows.min()}, {rows.max()}], cols in "
            f"[{cols.min()}, {cols.max()}]")
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if len(rows):
        # Duplicates are adjacent after the sort: group-sum with
        # reduceat (np.unique + add.at re-sorts and scatters — measured
        # ~10x slower at remainder scale).
        key = rows * n + cols
        first = np.empty(len(key), bool)
        first[0] = True
        np.not_equal(key[1:], key[:-1], out=first[1:])
        idx = np.flatnonzero(first)
        vals = np.add.reduceat(vals, idx)
        rows, cols = rows[idx], cols[idx]
    return rows, cols, vals


def _ell_from_coo_np(rows, cols, vals, n, pad_width: Optional[int] = None):
    """Host-side COO -> padded ELL conversion (duplicates are summed)."""
    rows, cols, vals = _coo_dedup_np(rows, cols, vals, n)
    counts = np.bincount(rows, minlength=n)
    L = int(counts.max()) if len(rows) else 1
    if pad_width is not None:
        require(pad_width >= L, OperatorError,
                f"pad_width={pad_width} < max row nnz {L}")
        L = pad_width
    L = max(L, 1)
    # Slot position of each entry within its row.
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(len(rows)) - starts[rows]
    indices = np.tile(np.arange(n, dtype=np.int64)[:, None], (1, L))
    values = np.zeros((n, L), vals.dtype)
    indices[rows, slot] = cols
    values[rows, slot] = vals
    return indices.astype(np.int32), values


@jax.tree_util.register_pytree_node_class
class ELLOperator(LinearOperator):
    """Padded-row (ELLPACK) sparse symmetric operator.

    Stores the *full* symmetric pattern (both triangles), ``indices`` and
    ``values`` of static shape ``(n, L)``; padded slots hold
    ``(row_index, 0.0)`` so they contribute nothing and every gather index
    stays in range (and shard-local under row sharding).

    ``chunk`` bounds the temporary gather buffer: the SpMM materializes at
    most ``(n, chunk, m)`` at a time.
    """

    def __init__(self, indices, values, chunk: int = 8):
        indices = jnp.asarray(indices, jnp.int32)
        values = jnp.asarray(values)
        require(indices.shape == values.shape and indices.ndim == 2,
                OperatorError,
                f"ELL needs matching (n, L) indices/values, got "
                f"{indices.shape} / {values.shape}")
        self.indices = indices
        self.values = values
        self.chunk = int(chunk)

    # -- constructors ---------------------------------------------------
    @classmethod
    def from_coo(cls, rows, cols, vals, n: int, dtype=jnp.float64,
                 pad_width: Optional[int] = None, chunk: int = 8,
                 use_native: bool = True):
        """Build from COO triplets. Assembly runs in the native C++
        component (``fortran_davidson_tpu.native``) when available, with
        a bit-identical numpy fallback."""
        vals_np = np.asarray(vals, np.dtype(jnp.dtype(dtype).name))
        if use_native:
            from fortran_davidson_tpu import native
            out = native.ell_from_coo(np.asarray(rows), np.asarray(cols),
                                      vals_np, n, pad_width)
            if out is not None:
                return cls(out[0], out[1], chunk=chunk)
        idx, val = _ell_from_coo_np(np.asarray(rows), np.asarray(cols),
                                    vals_np, n, pad_width)
        return cls(idx, val, chunk=chunk)

    @classmethod
    def from_csr(cls, indptr, indices, data, dtype=jnp.float64,
                 pad_width: Optional[int] = None, chunk: int = 8):
        indptr = np.asarray(indptr, np.int64)
        n = len(indptr) - 1
        rows = np.repeat(np.arange(n), np.diff(indptr))
        return cls.from_coo(rows, indices, np.asarray(data, jnp.dtype(dtype)),
                            n, dtype=dtype, pad_width=pad_width, chunk=chunk)

    @classmethod
    def from_dense(cls, matrix, tol: float = 0.0, chunk: int = 8):
        m = np.asarray(matrix)
        rows, cols = np.nonzero(np.abs(m) > tol)
        return cls.from_coo(rows, cols, m[rows, cols], m.shape[0],
                            dtype=m.dtype, chunk=chunk)

    # -- LinearOperator -------------------------------------------------
    @property
    def shape(self):
        return (self.indices.shape[0], self.indices.shape[0])

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def nnz_per_row(self) -> int:
        return self.indices.shape[1]

    @property
    def nnz(self) -> int:
        """Stored nonzero count (host-side)."""
        return int(np.count_nonzero(np.asarray(self.values)))

    def matmat(self, block):
        return _ell_chunked_apply(self.indices, self.values, block,
                                  self.chunk)

    def matmat_ds(self, x_hi, x_lo):
        """Compensated DS apply: chunk partials combined with exact
        two_sum, lo channel through a plain pass (see
        :meth:`BSROperator.matmat_ds` for the accuracy contract — the
        remaining per-chunk rounding is ~eps * |stored| * |x|, eps²-grade
        on off-diagonal splits of diagonal-dominant operators)."""
        return _ell_chunked_apply_ds(self.indices, self.values,
                                     x_hi, x_lo, self.chunk)

    def diagonal(self):
        n = self.indices.shape[0]
        on_diag = self.indices == jnp.arange(n, dtype=jnp.int32)[:, None]
        return jnp.sum(jnp.where(on_diag, self.values, 0), axis=1)

    def offdiag(self):
        """Exact off-diagonal split: stored diagonal slots zeroed."""
        n = self.indices.shape[0]
        on_diag = self.indices == jnp.arange(n, dtype=jnp.int32)[:, None]
        return ELLOperator(self.indices,
                           jnp.where(on_diag, 0, self.values),
                           chunk=self.chunk)

    def to_dense(self):
        n, L = self.indices.shape
        dense = jnp.zeros((n, n), self.dtype)
        rows = jnp.broadcast_to(jnp.arange(n)[:, None], (n, L))
        return dense.at[rows, self.indices].add(self.values)

    # -- pytree ----------------------------------------------------------
    def tree_flatten(self):
        return (self.indices, self.values), (self.chunk,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.indices, obj.values = children
        (obj.chunk,) = aux
        return obj


def _ell_chunked_apply(indices, values, block, chunk):
    """Chunked gather + einsum over one fixed-width slot table.

    ``indices``/``values``: (r, L); returns (r, m). The shared inner
    SpMM of :class:`ELLOperator` and :class:`SlicedELLOperator` —
    static-shape work whose peak temporary is (r, chunk, m).
    """
    r, L = indices.shape
    m = block.shape[1]
    dt = block.dtype
    c = max(1, min(chunk, L))
    nfull, rem = divmod(L, c)

    def piece(idx, val):
        gathered = jnp.take(block, idx, axis=0)           # (r, c, m)
        return jnp.einsum("nl,nlm->nm", val.astype(dt), gathered)

    out = jnp.zeros((r, m), dt)
    if nfull:
        idx3 = indices[:, : nfull * c].reshape(r, nfull, c)
        val3 = values[:, : nfull * c].reshape(r, nfull, c)

        def body(i, acc):
            idx = jax.lax.dynamic_index_in_dim(idx3, i, 1, keepdims=False)
            val = jax.lax.dynamic_index_in_dim(val3, i, 1, keepdims=False)
            return acc + piece(idx, val)

        out = jax.lax.fori_loop(0, nfull, body, out)
    if rem:
        out = out + piece(indices[:, nfull * c:], values[:, nfull * c:])
    return out


def _ell_chunked_apply_ds(indices, values, x_hi, x_lo, chunk):
    """DS sibling of :func:`_ell_chunked_apply`: every chunk partial is
    folded with exact two_sum (hi channel) and the lo input channel's
    contribution (first-order small) rides in the error channel."""
    from fortran_davidson_tpu.utils import ds as dsm
    r, L = indices.shape
    m = x_hi.shape[1]
    dt = x_hi.dtype
    c = max(1, min(chunk, L))
    nfull, rem = divmod(L, c)
    hp = jax.lax.Precision.HIGHEST

    def piece(idx, val, x):
        gathered = jnp.take(x, idx, axis=0)               # (r, c, m)
        return jnp.einsum("nl,nlm->nm", val.astype(dt), gathered,
                          preferred_element_type=dt, precision=hp)

    hi = jnp.zeros((r, m), dt)
    lo = jnp.zeros((r, m), dt)
    if nfull:
        idx3 = indices[:, : nfull * c].reshape(r, nfull, c)
        val3 = values[:, : nfull * c].reshape(r, nfull, c)

        def body(i, carry):
            h, l = carry
            idx = jax.lax.dynamic_index_in_dim(idx3, i, 1, keepdims=False)
            val = jax.lax.dynamic_index_in_dim(val3, i, 1, keepdims=False)
            h2, e = dsm.two_sum(h, piece(idx, val, x_hi))
            return h2, l + e + piece(idx, val, x_lo)

        hi, lo = jax.lax.fori_loop(0, nfull, body, (hi, lo))
    if rem:
        idx, val = indices[:, nfull * c:], values[:, nfull * c:]
        hi, e = dsm.two_sum(hi, piece(idx, val, x_hi))
        lo = lo + e + piece(idx, val, x_lo)
    return dsm.fast_two_sum(hi, lo)


@jax.tree_util.register_pytree_node_class
class SlicedELLOperator(LinearOperator):
    """Row-length-sorted sliced ELL (SELL-σ with a global sort, σ = n).

    The plain :class:`ELLOperator` pads EVERY row to the longest row's
    width, and each padded slot costs real gather work — unstructured
    gather cost is per gathered SLOT, padding included. Physically
    meaningful remainders
    (what is left after the banded split, ``split_band_remainder``) are
    extremely skewed: most rows hold zero or a couple of stray couplings
    while a handful hold many, so padded-ELL gather traffic is dominated
    by zeros.

    This operator sorts rows by stored-entry count and groups them into
    contiguous BUCKETS of power-of-two width, each padded only to its
    own width (≤ 2x internal waste); rows with no entries are dropped
    from the compute entirely. One final ``n``-row gather maps the
    concatenated bucket outputs back to the original row order, so no
    scatter appears in the hot path. Gather traffic falls from
    ``n * L_max`` slots to ``Σ_b rows_b * 2^b + n``.

    The reference's analogue is the on-the-fly dense row loop
    (``src/davidson.f90:559-567``) — it has no sparse storage at all;
    this is the static-shape answer for the unstructured tail.

    Static shapes throughout: the bucket layout is fixed at construction
    (host-side numpy), so ``jit`` sees a handful of fixed-width gathers.
    """

    def __init__(self, bucket_rows, bucket_indices, bucket_values,
                 gather_map, chunk: int = 8):
        bucket_rows = tuple(jnp.asarray(r, jnp.int32) for r in bucket_rows)
        bucket_indices = tuple(jnp.asarray(i, jnp.int32)
                               for i in bucket_indices)
        bucket_values = tuple(jnp.asarray(v) for v in bucket_values)
        require(len(bucket_rows) == len(bucket_indices)
                == len(bucket_values) > 0,
                OperatorError, "sliced ELL needs >= 1 (rows, idx, val) "
                "bucket triple (an empty (0, 1) bucket is fine)")
        for r, i, v in zip(bucket_rows, bucket_indices, bucket_values):
            require(i.shape == v.shape and i.ndim == 2
                    and r.shape == i.shape[:1], OperatorError,
                    f"bucket shape mismatch: rows {r.shape}, idx "
                    f"{i.shape}, val {v.shape}")
        self.bucket_rows = bucket_rows
        self.bucket_indices = bucket_indices
        self.bucket_values = bucket_values
        # gather_map[i] = position of row i in the concatenated bucket
        # output, or the appended all-zero row for empty rows.
        self.gather_map = jnp.asarray(gather_map, jnp.int32)
        self.chunk = int(chunk)

    # -- constructors ---------------------------------------------------
    @classmethod
    def from_coo(cls, rows, cols, vals, n: int, dtype=jnp.float64,
                 chunk: int = 8):
        """Build from COO triplets (duplicates summed, host-side)."""
        vals_np = np.asarray(vals, np.dtype(jnp.dtype(dtype).name))
        rows, cols, vals_np = _coo_dedup_np(
            np.asarray(rows), np.asarray(cols), vals_np, n)
        counts = np.bincount(rows, minlength=n)
        starts = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=starts[1:])

        nz_rows = np.nonzero(counts)[0]
        # Power-of-two bucket widths: rows with count in (2^(k-1), 2^k]
        # share a bucket, bounding internal padding at 2x while keeping
        # the number of compiled gather widths at log2(L_max).
        widths = (1 << np.ceil(np.log2(np.maximum(
            counts[nz_rows], 1))).astype(np.int64)) if len(nz_rows) else \
            np.zeros(0, np.int64)
        # Fully vectorized slot placement (a per-row Python loop would
        # dominate setup at remainder scale): each entry's slot is its
        # rank within its row, its target row is the row's position in
        # the width-descending global sort.
        slot_of = np.arange(len(rows)) - starts[rows]
        row_width = (widths[np.searchsorted(nz_rows, rows)]
                     if len(rows) else np.zeros(0, np.int64))
        positions = np.full(n, -1, np.int64)
        b_rows, b_idx, b_val = [], [], []
        pos = 0
        for w in sorted(set(widths.tolist()), reverse=True):
            sel = np.sort(nz_rows[widths == w])
            positions[sel] = pos + np.arange(len(sel))
            pos += len(sel)
            in_b = row_width == w
            rb = rows[in_b]
            local = np.searchsorted(sel, rb)
            idx_b = np.tile(sel[:, None], (1, w)).astype(np.int64)
            val_b = np.zeros((len(sel), w), vals_np.dtype)
            idx_b[local, slot_of[in_b]] = cols[in_b]
            val_b[local, slot_of[in_b]] = vals_np[in_b]
            b_rows.append(sel.astype(np.int32))
            b_idx.append(idx_b.astype(np.int32))
            b_val.append(val_b)
        if not b_rows:  # no stored entries at all: one empty bucket
            b_rows = [np.zeros(0, np.int32)]
            b_idx = [np.zeros((0, 1), np.int32)]
            b_val = [np.zeros((0, 1), vals_np.dtype)]
        gather_map = np.where(positions >= 0, positions, pos)
        return cls(b_rows, b_idx, b_val, gather_map, chunk=chunk)

    @classmethod
    def from_ell(cls, op: ELLOperator):
        """Re-slice an existing padded ELL operator (host-side)."""
        idx = np.asarray(op.indices)
        val = np.asarray(op.values)
        n = idx.shape[0]
        keep = val != 0
        rows = np.broadcast_to(np.arange(n)[:, None], idx.shape)[keep]
        return cls.from_coo(rows, idx[keep], val[keep], n,
                            dtype=val.dtype, chunk=op.chunk)

    def to_ell(self) -> ELLOperator:
        """Host-side conversion back to the uniformly padded layout.

        The GSPMD row-sharded path needs it: a (n, L) table partitions
        by rows with no cross-shard output movement, while the sliced
        layout's unsort gather would cross shards.
        """
        r2, c2, v2 = [], [], []
        for r, i, v in zip(self.bucket_rows, self.bucket_indices,
                           self.bucket_values):
            keep = np.asarray(v) != 0
            r2.append(np.broadcast_to(
                np.asarray(r)[:, None], i.shape)[keep])
            c2.append(np.asarray(i)[keep])
            v2.append(np.asarray(v)[keep])
        n = int(self.gather_map.shape[0])
        return ELLOperator.from_coo(
            np.concatenate(r2) if r2 else np.zeros(0, np.int64),
            np.concatenate(c2) if c2 else np.zeros(0, np.int64),
            np.concatenate(v2) if v2 else np.zeros(0, self.dtype),
            n, dtype=self.dtype, chunk=self.chunk)

    # -- LinearOperator -------------------------------------------------
    @property
    def shape(self):
        n = self.gather_map.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.bucket_values[0].dtype

    @property
    def nnz(self) -> int:
        """Stored nonzero count (host-side)."""
        return sum(int(np.count_nonzero(np.asarray(v)))
                   for v in self.bucket_values)

    @property
    def gather_slots(self) -> int:
        """Static gather traffic per SpMM, in slots (the padded-ELL
        equivalent is ``n * L_max``). Includes the final unsort gather."""
        return (sum(int(i.shape[0]) * int(i.shape[1])
                    for i in self.bucket_indices)
                + int(self.gather_map.shape[0]))

    def matmat(self, block):
        m = block.shape[1]
        dt = block.dtype
        outs = [_ell_chunked_apply(i, v, block, self.chunk)
                for i, v in zip(self.bucket_indices, self.bucket_values)]
        outs.append(jnp.zeros((1, m), dt))      # empty-row target
        stacked = jnp.concatenate(outs, axis=0)
        return jnp.take(stacked, self.gather_map, axis=0)

    def matmat_ds(self, x_hi, x_lo):
        """Compensated DS apply: per-bucket DS partials (see
        :meth:`ELLOperator.matmat_ds`), both channels unsorted with the
        same gather (the unsort moves values, it adds no arithmetic)."""
        m = x_hi.shape[1]
        dt = x_hi.dtype
        his, los = [], []
        for i, v in zip(self.bucket_indices, self.bucket_values):
            h, l = _ell_chunked_apply_ds(i, v, x_hi, x_lo, self.chunk)
            his.append(h)
            los.append(l)
        his.append(jnp.zeros((1, m), dt))
        los.append(jnp.zeros((1, m), dt))
        return (jnp.take(jnp.concatenate(his, axis=0), self.gather_map,
                         axis=0),
                jnp.take(jnp.concatenate(los, axis=0), self.gather_map,
                         axis=0))

    def diagonal(self):
        n = self.gather_map.shape[0]
        d = jnp.zeros((n,), self.dtype)
        for r, i, v in zip(self.bucket_rows, self.bucket_indices,
                           self.bucket_values):
            on_diag = i == r[:, None]
            d = d.at[r].add(jnp.sum(jnp.where(on_diag, v, 0), axis=1))
        return d

    def offdiag(self) -> "SlicedELLOperator":
        """Exact off-diagonal split: stored diagonal slots zeroed."""
        vals = tuple(
            jnp.where(i == r[:, None], 0, v)
            for r, i, v in zip(self.bucket_rows, self.bucket_indices,
                               self.bucket_values))
        return SlicedELLOperator(self.bucket_rows, self.bucket_indices,
                                 vals, self.gather_map, chunk=self.chunk)

    def to_dense(self):
        n = self.gather_map.shape[0]
        dense = jnp.zeros((n, n), self.dtype)
        for r, i, v in zip(self.bucket_rows, self.bucket_indices,
                           self.bucket_values):
            dense = dense.at[r[:, None], i].add(v)
        return dense

    # -- pytree ----------------------------------------------------------
    def tree_flatten(self):
        children = (self.bucket_rows, self.bucket_indices,
                    self.bucket_values, self.gather_map)
        return children, (self.chunk,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        (obj.bucket_rows, obj.bucket_indices, obj.bucket_values,
         obj.gather_map) = children
        (obj.chunk,) = aux
        return obj


def _slot_slices_dia(xb, bw: int, K: int):
    """Per-band-slot (nbr, bs, m) input slices of a DIA-aligned operator.

    Zero-pads ``bw`` block rows on each side and takes contiguous slices
    — no gather. Identical to the clipped-gather formulation because
    out-of-range band slots store zero blocks (0 * x == B_zero * x)."""
    nbr = xb.shape[0]
    xp = jnp.pad(xb, ((bw, bw), (0, 0), (0, 0)))
    return [xp[k:k + nbr] for k in range(K)]


def _slot_slices_gather(xb, block_cols):
    """Per-slot input slices via the stored block-column table."""
    return [jnp.take(xb, block_cols[:, k], axis=0)
            for k in range(block_cols.shape[1])]


def _ds_slot_accumulate(parts_hi, parts_lo):
    """Exact two_sum fold of per-slot (hi, lo) contributions.

    Every slot-combine rounding lands in the lo channel; only the
    slots' own internal matmul rounding (captured by the caller's
    error analysis, not compensated here) remains."""
    from fortran_davidson_tpu.utils import ds as dsm
    y_hi, y_lo = parts_hi[0], parts_lo[0]
    for ph, pl in zip(parts_hi[1:], parts_lo[1:]):
        y_hi, e = dsm.two_sum(y_hi, ph)
        y_lo = y_lo + pl + e
    return dsm.fast_two_sum(y_hi, y_lo)


def _two_pass_gram(op, block, vv, write_out):
    """``matmat_with_gram`` as two passes: ``Y = A @ X``, then the f32
    gram ``Vᵀ Y`` (a plain GEMM). No operator fuses the pair today."""
    y = op.matmat(block)
    g = jnp.einsum("nv,nm->vm", vv.astype(jnp.float32),
                   y.astype(jnp.float32),
                   preferred_element_type=jnp.float32)
    return (y, g) if write_out else g


@jax.tree_util.register_pytree_node_class
class BSROperator(LinearOperator):
    """Block-ELL sparse symmetric operator (dense ``bs x bs`` blocks).

    ``block_cols``: (nbr, K) int32 — block-column index of each stored
    block (padded slots point at the row's own block index).
    ``blocks``: (nbr, bs, K*bs) — dense blocks in *row-major block*
    layout: ``blocks[r, :, k*bs:(k+1)*bs]`` is the ``bs x bs`` block at
    ``(r, block_cols[r, k])``. A whole block row contracts as ONE
    ``(bs, K*bs) @ (K*bs, m)`` matmul — large dots instead of K small
    ones — in the XLA einsum path. The layout is stored 3-D (not reshaped
    on the fly) because a reshape inside the solver's jitted hot loop can
    materialize the whole table per iteration.

    ``backend`` picks the apply path (see
    :func:`~fortran_davidson_tpu.ops.pallas_kernels.kernel_mode`):
    ``"xla"`` (default), ``"auto"`` (the Pallas kernel on a GPU, XLA
    elsewhere), ``"pallas"`` (the compiled kernel; raises off a GPU) or
    ``"pallas-interpret"``. Only DIA-banded storage with a power-of-two
    block size >= 32 and bf16 blocks takes the kernel; every other
    operator applies through XLA whatever the backend.
    """

    def __init__(self, block_cols, blocks, backend: str = "xla",
                 bandwidth: Optional[int] = None):
        block_cols = jnp.asarray(block_cols, jnp.int32)
        blocks = jnp.asarray(blocks)
        require(blocks.ndim == 3 and block_cols.ndim == 2
                and blocks.shape[0] == block_cols.shape[0]
                and blocks.shape[2]
                    == block_cols.shape[1] * blocks.shape[1],
                OperatorError,
                f"BSR needs (nbr, K) block_cols and (nbr, bs, K*bs) blocks, "
                f"got {block_cols.shape} / {blocks.shape}")
        require(backend in BACKENDS, OperatorError,
                f"unknown BSR backend {backend!r}")
        if bandwidth is not None:
            require(block_cols.shape[1] == 2 * bandwidth + 1, OperatorError,
                    "banded BSR needs K == 2*bandwidth + 1 window-aligned "
                    f"slots, got K={block_cols.shape[1]}, bw={bandwidth}")
        self.block_cols = block_cols
        self.blocks = blocks
        self.backend = backend
        # Declared block bandwidth for DIA-aligned banded storage (slot k
        # of row r holds column r-bw+k, zero blocks out of range): the
        # Pallas kernel reads contiguous x rows per slot, no gather.
        self.bandwidth = None if bandwidth is None else int(bandwidth)

    # -- constructors ---------------------------------------------------
    @classmethod
    def from_block_coo(cls, brows, bcols, block_vals, n_block_rows: int,
                       pad_width: Optional[int] = None, backend="xla"):
        """Build from block-COO (host-side): ``block_vals[i]`` is the dense
        block at block position ``(brows[i], bcols[i])``."""
        brows = np.asarray(brows, np.int64)
        bcols = np.asarray(bcols, np.int64)
        block_vals = np.asarray(block_vals)
        bs = block_vals.shape[-1]
        nbr = n_block_rows
        order = np.lexsort((bcols, brows))
        brows, bcols, block_vals = brows[order], bcols[order], block_vals[order]
        counts = np.bincount(brows, minlength=nbr)
        K = int(counts.max()) if len(brows) else 1
        if pad_width is not None:
            require(pad_width >= K, OperatorError,
                    f"pad_width={pad_width} < max blocks/row {K}")
            K = pad_width
        K = max(K, 1)
        starts = np.zeros(nbr + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        slot = np.arange(len(brows)) - starts[brows]
        cols = np.tile(np.arange(nbr, dtype=np.int64)[:, None], (1, K))
        vals = np.zeros((nbr, K, bs, bs), block_vals.dtype)
        cols[brows, slot] = bcols
        vals[brows, slot] = block_vals
        return cls(cols.astype(np.int32),
                   np.ascontiguousarray(vals.transpose(0, 2, 1, 3)).reshape(
                       nbr, bs, K * bs),
                   backend=backend)

    @classmethod
    def from_dense(cls, matrix, bs: int, tol: float = 0.0, backend="xla"):
        m = np.asarray(matrix)
        n = m.shape[0]
        require(n % bs == 0, OperatorError,
                f"matrix dim {n} not divisible by block size {bs}")
        nbr = n // bs
        t = m.reshape(nbr, bs, nbr, bs).transpose(0, 2, 1, 3)
        nz = np.abs(t).max(axis=(2, 3)) > tol
        brows, bcols = np.nonzero(nz)
        return cls.from_block_coo(brows, bcols, t[brows, bcols], nbr,
                                  backend=backend)

    # -- LinearOperator -------------------------------------------------
    @property
    def block_size(self) -> int:
        return self.blocks.shape[1]

    @property
    def n_block_rows(self) -> int:
        return self.blocks.shape[0]

    @property
    def blocks_per_row(self) -> int:
        return self.blocks.shape[2] // self.blocks.shape[1]

    @property
    def shape(self):
        n = self.n_block_rows * self.block_size
        return (n, n)

    @property
    def dtype(self):
        return self.blocks.dtype

    def matmat(self, block):
        # Mixed precision: with sub-32-bit stored blocks (bf16 operators)
        # the input block is cast DOWN for the contraction and the result
        # accumulated/returned at the input's precision — the bandwidth
        # win of bf16 storage without changing the solver's dtype.
        target = block.dtype
        compute = self.dtype if jnp.dtype(self.dtype).itemsize < \
            jnp.dtype(target).itemsize else target
        mode = kernel_mode(self.backend, kernel_supported(
            self.block_size, self.blocks_per_row, self.bandwidth, compute))
        if mode is not None:
            return banded_spmm(self.blocks.astype(compute), block,
                               bandwidth=self.bandwidth, out_dtype=target,
                               interpret=mode == "interpret")
        nbr, bs, kbs = self.blocks.shape
        K = kbs // bs
        m = block.shape[1]
        xb = block.astype(compute).reshape(nbr, bs, m)
        gathered = jnp.take(xb, self.block_cols, axis=0)   # (nbr, K, bs, m)
        gathered = gathered.reshape(nbr, K * bs, m)
        out = jnp.einsum("rab,rbm->ram", self.blocks.astype(compute),
                         gathered, preferred_element_type=target)
        return out.reshape(nbr * bs, m).astype(target)

    def matmat_with_gram(self, block, v=None, *, write_out: bool = True):
        """``Y = A @ X`` and ``G = Vᵀ Y`` (``v=None`` → V = X), the
        Davidson hot pair (reference gemms ``src/davidson.f90:131,159``),
        composed in two passes."""
        return _two_pass_gram(self, block, block if v is None else v,
                              write_out)

    def matmat_ds(self, x_hi, x_lo):
        """Compensated double-single block apply (slot-split + exact
        combine; see :meth:`LinearOperator.matmat_ds`).

        Each band slot contracts as its own f32 HIGHEST-precision
        ``(bs, bs) @ (bs, m)`` einsum and the K per-slot partials are
        combined with exact ``two_sum``; the lo input channel passes
        through the same per-slot contraction in plain f32 (first-order
        small) and lands in the error channel. What remains is each
        slot's OWN product/accumulation rounding, ~eps * sqrt(bs) *
        |stored entries| * |x| per element — far below the full-slab
        apply's eps*|A x| floor exactly when the stored entries are
        small against the solve's eigenvalue scale, i.e. on the
        OFF-DIAGONAL split of a diagonal-dominant operator (the refined
        solver's ``A_off``, this method's intended caller; the fixture's
        1e-3-scale couplings measure ~1e-10-grade error at 10M rows,
        tests/test_ds_apply.py). On a full operator whose dominant
        diagonal lives in the center slot the center contraction rounds
        at eps*|d x| and this is no better than :meth:`matmat`.
        Reference analogue: real64 residual evaluation,
        ``/root/reference/src/davidson.f90:163-170,401-410``.
        """
        nbr, bs, kbs = self.blocks.shape
        K = kbs // bs
        m = x_hi.shape[1]
        dt = x_hi.dtype
        xb_hi = x_hi.reshape(nbr, bs, m)
        xb_lo = x_lo.reshape(nbr, bs, m)
        if self.bandwidth is not None:
            hi_slices = _slot_slices_dia(xb_hi, self.bandwidth, K)
            lo_slices = _slot_slices_dia(xb_lo, self.bandwidth, K)
        else:
            hi_slices = _slot_slices_gather(xb_hi, self.block_cols)
            lo_slices = _slot_slices_gather(xb_lo, self.block_cols)
        hp = jax.lax.Precision.HIGHEST
        parts_hi, parts_lo = [], []
        for k in range(K):
            blk = self.blocks[:, :, k * bs:(k + 1) * bs].astype(dt)
            parts_hi.append(jnp.einsum("rab,rbm->ram", blk, hi_slices[k],
                                       preferred_element_type=dt,
                                       precision=hp))
            parts_lo.append(jnp.einsum("rab,rbm->ram", blk, lo_slices[k],
                                       preferred_element_type=dt,
                                       precision=hp))
        y_hi, y_lo = _ds_slot_accumulate(parts_hi, parts_lo)
        return y_hi.reshape(nbr * bs, m), y_lo.reshape(nbr * bs, m)

    def _blocks4(self):
        nbr, bs, kbs = self.blocks.shape
        return self.blocks.reshape(nbr, bs, kbs // bs, bs)

    def diagonal(self):
        nbr, bs, _ = self.blocks.shape
        if self.bandwidth is not None:
            # DIA-aligned band: the diagonal block is always slot bw — a
            # plain slice, avoiding the (nbr, bs, K, bs)-sized masked temp
            # (which alone OOMs HBM at 10M-row scale).
            bw = self.bandwidth
            diag_blocks = self.blocks[:, :, bw * bs:(bw + 1) * bs]
        else:
            own = self.block_cols == jnp.arange(nbr, dtype=jnp.int32)[:, None]
            diag_blocks = jnp.sum(
                jnp.where(own[:, None, :, None], self._blocks4(), 0), axis=2)
        return jnp.diagonal(diag_blocks, axis1=1, axis2=2).reshape(-1)

    def to_dense(self):
        nbr, bs, kbs = self.blocks.shape
        K = kbs // bs
        n = nbr * bs
        dense = jnp.zeros((nbr, nbr, bs, bs), self.dtype)
        rows = jnp.broadcast_to(jnp.arange(nbr)[:, None], (nbr, K))
        dense = dense.at[rows, self.block_cols].add(
            self._blocks4().transpose(0, 2, 1, 3))
        return dense.transpose(0, 2, 1, 3).reshape(n, n)

    def offdiag(self) -> "BSROperator":
        """Exact off-diagonal split: diagonal entries of on-diagonal
        blocks zeroed (one O(nnz) pass at construction, not solve time)."""
        nbr, bs, kbs = self.blocks.shape
        K = kbs // bs
        i = jax.lax.broadcasted_iota(jnp.int32, (bs, K * bs), 0)
        j = jax.lax.broadcasted_iota(jnp.int32, (bs, K * bs), 1)
        in_block_diag = i == (j % bs)  # (bs, K*bs): diag of each slot
        slot_of = j // bs
        if self.bandwidth is not None:
            own = (slot_of == self.bandwidth)[None, :, :]
            mask = own & in_block_diag[None, :, :]
        else:
            # slot k of row r is the diagonal block iff block_cols[r,k]==r
            own = (self.block_cols
                   == jnp.arange(nbr, dtype=jnp.int32)[:, None])  # (nbr, K)
            mask = own[:, None, :][
                :, :, slot_of[0]] & in_block_diag[None, :, :]
        return BSROperator(self.block_cols,
                           jnp.where(mask, 0, self.blocks),
                           backend=self.backend, bandwidth=self.bandwidth)

    def with_backend(self, backend: str) -> "BSROperator":
        return BSROperator(self.block_cols, self.blocks, backend=backend,
                           bandwidth=self.bandwidth)

    def astype(self, dtype) -> "BSROperator":
        """Recast stored blocks (e.g. to bfloat16 for mixed-precision
        solves: f32 solver iterates, bf16 operator storage)."""
        return BSROperator(self.block_cols, self.blocks.astype(dtype),
                           backend=self.backend, bandwidth=self.bandwidth)

    # -- pytree ----------------------------------------------------------
    def tree_flatten(self):
        return (self.block_cols, self.blocks), (self.backend, self.bandwidth)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.block_cols, obj.blocks = children
        obj.backend, obj.bandwidth = aux
        return obj


def generate_sparse_diagonal_dominant(n: int, nnz_per_row: int,
                                      sparsity: float = 1e-3,
                                      seed: int = 0, dtype=jnp.float64,
                                      chunk: int = 8) -> ELLOperator:
    """Random sparse symmetric diagonal-dominant matrix in ELL form.

    The sparse sibling of the reference fixture
    (``src/array_utils.f90:86-113``): diagonal ``1..n``, ~``nnz_per_row``
    off-diagonal entries per row of magnitude ~``sparsity``, symmetric.
    Host-side numpy construction (one-time setup).
    """
    rng = np.random.default_rng(seed)
    # Sample unordered pairs uniformly (drawing j from (i, n) would bias
    # entries toward high rows and blow up the padded ELL width); each
    # row then receives ~Poisson(nnz_per_row - 1) off-diagonal entries.
    n_pairs = max(n * max(nnz_per_row - 1, 0) // 2, 0)
    dt = np.dtype(jnp.dtype(dtype).name)
    if n_pairs and n > 1:
        i = rng.integers(0, n, n_pairs)
        j = rng.integers(0, n - 1, n_pairs)
        j = np.where(j >= i, j + 1, j)  # uniform over j != i
        v = (rng.random(n_pairs).astype(dt)) * sparsity
        rows = np.concatenate([i, j, np.arange(n)])
        cols = np.concatenate([j, i, np.arange(n)])
        vals = np.concatenate([v, v, np.arange(1, n + 1, dtype=dt)])
    else:
        rows = cols = np.arange(n)
        vals = np.arange(1, n + 1, dtype=dt)
    return ELLOperator.from_coo(rows, cols, vals, n, dtype=dtype, chunk=chunk)


def generate_banded_bsr(n_block_rows: int, bs: int, bandwidth: int = 1,
                        coupling: float = 1e-3, seed: int = 0,
                        dtype=jnp.float64, backend="xla") -> BSROperator:
    """Banded block-sparse symmetric diagonal-dominant matrix.

    Block-tridiagonal-style fixture for the BSR / halo-exchange paths
    (north-star workload shape): dense diagonal blocks with dominant
    diagonal ``1..n``, small random coupling blocks within ``bandwidth``
    block-diagonals on each side.
    """
    rng = np.random.default_rng(seed)
    dt = np.dtype(jnp.dtype(dtype).name)
    nbr = n_block_rows
    bw = bandwidth
    K = 2 * bw + 1
    require(nbr >= K, OperatorError,
            f"need at least K={K} block rows for bandwidth {bw}")
    # DIA-aligned block-ELL assembly: slot k of row r holds column
    # r - bw + k for EVERY row (out-of-range band positions stay zero
    # blocks; their stored column index is clipped in range for gather
    # safety). The uniform slot rule is what makes the Pallas kernel
    # edge-free and shard_map-composable — a row's K
    # slices always sit at offset r (in local/virtual coordinates) of
    # the halo-extended input window.
    offs = np.arange(nbr)[:, None] - bw + np.arange(K)   # virtual columns
    cols = np.clip(offs, 0, nbr - 1)                     # gather-safe
    vals = np.zeros((nbr, K, bs, bs), dt)

    # Off-diagonal bands (upper), mirrored for symmetry; diagonal d lives
    # in slot bw + d of row r (DIA rule).
    for d in range(1, bw + 1):
        cnt = nbr - d
        if cnt <= 0:
            continue
        blocks = (rng.random((cnt, bs, bs)).astype(dt) - 0.5) * coupling
        r = np.arange(cnt)
        vals[r, bw + d] = blocks
        vals[r + d, bw - d] = blocks.transpose(0, 2, 1)
    # Diagonal blocks: symmetric small coupling + dominant diagonal.
    dblocks = (rng.random((nbr, bs, bs)).astype(dt) - 0.5) * coupling
    dblocks = dblocks + dblocks.transpose(0, 2, 1)
    diag = np.arange(1, nbr * bs + 1, dtype=dt).reshape(nbr, bs)
    idx = np.arange(bs)
    dblocks[:, idx, idx] = diag
    vals[:, bw] = dblocks
    return BSROperator(cols.astype(np.int32),
                       np.ascontiguousarray(vals.transpose(0, 2, 1, 3)).reshape(
                           nbr, bs, K * bs),
                       backend=backend, bandwidth=bw)


@jax.tree_util.register_pytree_node_class
class QuantizedBandedOperator(LinearOperator):
    """int8-quantized banded BSR operator (opt-in bandwidth saver).

    Stores the OFF-diagonal part of a DIA-aligned banded operator as
    int8 blocks with one f32 scale per (block row, band slot), plus the
    exact f32 matrix diagonal. The diagonal split is what makes int8
    viable for the diagonal-dominant operators this solver targets
    (diag ~ 1..n in-band would force every off-diagonal coupling to
    quantize to zero under a shared scale); it also gives
    :meth:`diagonal` / :meth:`offdiag` exactly — the refined
    double-single solver path composes with quantized storage unchanged.

    Accuracy: off-diagonal entries carry ~0.4% relative quantization
    error (int8 symmetric, per-slot scale) — bf16-class tolerances only.
    Block traffic halves vs bf16 storage (quarters vs f32); the scale
    rows + diagonal add ~3%. Build with :func:`quantize_banded_int8`.

    ``backend`` as for :class:`BSROperator`; the default ``"auto"`` takes
    the Pallas kernel on a GPU and the plain DIA slot-sum elsewhere.
    """

    def __init__(self, qblocks, scale_rows, diag, bandwidth: int,
                 backend: str = "auto"):
        qblocks = jnp.asarray(qblocks, jnp.int8)
        scale_rows = jnp.asarray(scale_rows, jnp.float32)
        diag = jnp.asarray(diag, jnp.float32)
        nbr, bs, kbs = qblocks.shape
        require(scale_rows.shape == (nbr, kbs)
                and diag.shape == (nbr, bs), OperatorError,
                f"quantized banded needs (nbr, K*bs) scales and (nbr, bs) "
                f"diag for blocks {qblocks.shape}; got {scale_rows.shape} "
                f"/ {diag.shape}")
        require(kbs == (2 * bandwidth + 1) * bs, OperatorError,
                "quantized banded needs DIA-aligned K == 2*bw+1 slots")
        require(backend in BACKENDS, OperatorError,
                f"unknown backend {backend!r}")
        self.qblocks = qblocks
        self.scale_rows = scale_rows
        self.diag = diag
        self.bandwidth = int(bandwidth)
        self.backend = backend

    # -- LinearOperator -------------------------------------------------
    @property
    def block_size(self) -> int:
        return self.qblocks.shape[1]

    @property
    def n_block_rows(self) -> int:
        return self.qblocks.shape[0]

    @property
    def shape(self):
        n = self.n_block_rows * self.block_size
        return (n, n)

    @property
    def dtype(self):
        return self.scale_rows.dtype

    def matmat(self, block):
        nbr, bs, kbs = self.qblocks.shape
        mode = kernel_mode(self.backend, kernel_supported(
            bs, kbs // bs, self.bandwidth, jnp.int8))
        if mode is not None:
            return banded_spmm(self.qblocks, block, self.scale_rows,
                               self.diag, bandwidth=self.bandwidth,
                               interpret=mode == "interpret")
        return _quantized_dia_apply(self.qblocks, self.scale_rows,
                                    self.diag, block, self.bandwidth)

    def matmat_with_gram(self, block, v=None, *, write_out: bool = True):
        """Two-pass ``Y = A @ X``, ``G = Vᵀ Y`` (see
        :meth:`BSROperator.matmat_with_gram`)."""
        return _two_pass_gram(self, block, block if v is None else v,
                              write_out)

    def matmat_ds(self, x_hi, x_lo):
        """Compensated double-single apply on int8 storage.

        Exploits the format's structure for precision (see
        :meth:`BSROperator.matmat_ds` for the combine scheme):

        - per band slot, the INTEGER contraction ``Q_k @ x`` runs first
          (int8 values are exact in every float format — under HIGHEST
          precision the contraction carries them exactly) and the
          per-slot scale multiplies afterwards via exact ``two_prod``,
          so the only uncompensated rounding is the integer matmul's
          f32 accumulation, scaled DOWN by the tiny per-slot scale
          (~eps * sqrt(bs) * 127 * s * |x| ≈ 1e-10-grade for
          coupling-scale operators);
        - the separately stored exact diagonal enters through
          ``two_prod(d, x_hi)`` with its error and ``d * x_lo`` folded
          into the lo channel — no large-diagonal cancellation ever
          touches the hi channel. On the ``offdiag()`` instance the
          diagonal is zero and the term vanishes.

        This is what lets the int8 north-star operator converge to
        honest 1e-8 true residuals: the plain f32 apply's own output
        rounding (~1.4e-8 at 10M rows) otherwise floors the polish.
        """
        from fortran_davidson_tpu.utils import ds as dsm
        nbr, bs, kbs = self.qblocks.shape
        K = kbs // bs
        m = x_hi.shape[1]
        dt = x_hi.dtype
        xb_hi = x_hi.reshape(nbr, bs, m)
        xb_lo = x_lo.reshape(nbr, bs, m)
        hi_slices = _slot_slices_dia(xb_hi, self.bandwidth, K)
        lo_slices = _slot_slices_dia(xb_lo, self.bandwidth, K)
        # One scale per (block row, slot): every lane of a slot shares it.
        scales = self.scale_rows.reshape(nbr, K, bs)[:, :, 0].astype(dt)
        hp = jax.lax.Precision.HIGHEST
        parts_hi, parts_lo = [], []
        for k in range(K):
            qk = self.qblocks[:, :, k * bs:(k + 1) * bs].astype(dt)
            ik_hi = jnp.einsum("rab,rbm->ram", qk, hi_slices[k],
                               preferred_element_type=dt, precision=hp)
            ik_lo = jnp.einsum("rab,rbm->ram", qk, lo_slices[k],
                               preferred_element_type=dt, precision=hp)
            sk = scales[:, k][:, None, None]
            p, e = dsm.two_prod(ik_hi, sk)
            parts_hi.append(p)
            parts_lo.append(e + ik_lo * sk)
        # Exact diagonal term in DS.
        d = self.diag.astype(dt)[:, :, None]
        p, e = dsm.two_prod(d, xb_hi)
        parts_hi.append(p)
        parts_lo.append(e + d * xb_lo)
        y_hi, y_lo = _ds_slot_accumulate(parts_hi, parts_lo)
        return y_hi.reshape(nbr * bs, m), y_lo.reshape(nbr * bs, m)

    def diagonal(self):
        return self.diag.reshape(-1)

    def offdiag(self) -> "QuantizedBandedOperator":
        """Exact: the diagonal is stored separately — zero it out."""
        return QuantizedBandedOperator(
            self.qblocks, self.scale_rows, jnp.zeros_like(self.diag),
            bandwidth=self.bandwidth, backend=self.backend)

    def with_backend(self, backend: str) -> "QuantizedBandedOperator":
        return QuantizedBandedOperator(self.qblocks, self.scale_rows,
                                       self.diag, bandwidth=self.bandwidth,
                                       backend=backend)

    def to_dense(self):
        deq = (self.qblocks.astype(jnp.float32)
               * self.scale_rows[:, None, :])
        base = BSROperator(
            _dia_block_cols(self.n_block_rows, self.bandwidth),
            deq, backend="xla", bandwidth=self.bandwidth)
        return base.to_dense() + jnp.diag(self.diagonal())

    # -- pytree ----------------------------------------------------------
    def tree_flatten(self):
        return ((self.qblocks, self.scale_rows, self.diag),
                (self.bandwidth, self.backend))

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.qblocks, obj.scale_rows, obj.diag = children
        obj.bandwidth, obj.backend = aux
        return obj


def _quantized_dia_apply(qblocks, scale_rows, diag, x, bw: int,
                         halo: bool = False):
    """Plain XLA apply of int8 DIA-banded storage: the gather-free slot
    sum. Per band slot one batched ``(bs, bs) @ (bs, m)`` einsum of the
    int8 blocks (converted to f32) against contiguous rows of x, scaled
    by the slot's scale, plus the exact diagonal term. With ``halo=True``
    x carries ``bw`` halo block rows on each side (the row-sharded local
    slab) and every slot slice is in range; otherwise out-of-range slots
    read zero padding (their blocks are zero).

    The kernel's reference: same products and scales, other summation
    order.
    """
    nbr, bs, kbs = qblocks.shape
    K = kbs // bs
    m = x.shape[1]
    xb = x.astype(jnp.float32).reshape(-1, bs, m)
    if halo:
        slices = [xb[k:k + nbr] for k in range(K)]
    else:
        slices = _slot_slices_dia(xb, bw, K)
    out = diag[:, :, None] * slices[bw]
    for k in range(K):
        part = jnp.einsum("rab,rbm->ram",
                          qblocks[:, :, k * bs:(k + 1) * bs].astype(
                              jnp.float32), slices[k],
                          preferred_element_type=jnp.float32)
        out = out + scale_rows[:, k * bs][:, None, None] * part
    return out.reshape(nbr * bs, m).astype(x.dtype)


def _dia_block_cols(nbr: int, bw: int):
    offs = (np.arange(nbr)[:, None] - bw + np.arange(2 * bw + 1))
    return jnp.asarray(np.clip(offs, 0, nbr - 1), jnp.int32)


def quantize_banded_int8(op: BSROperator) -> QuantizedBandedOperator:
    """Quantize a DIA-aligned banded :class:`BSROperator` to int8 storage.

    Per band slot of each block row: symmetric int8 quantization of the
    off-diagonal entries (scale = max|block| / 127); the matrix diagonal
    is split out and kept exact in f32. See
    :class:`QuantizedBandedOperator` for the accuracy contract.
    """
    require(op.bandwidth is not None, OperatorError,
            "quantize_banded_int8 needs window-aligned banded storage "
            "(BSROperator(..., bandwidth=bw))")
    nbr, bs, kbs = op.blocks.shape
    K = kbs // bs
    bw = op.bandwidth
    off = op.offdiag().blocks.astype(jnp.float32)       # (nbr, bs, K*bs)
    b4 = off.reshape(nbr, bs, K, bs)
    amax = jnp.max(jnp.abs(b4), axis=(1, 3))            # (nbr, K)
    scales = jnp.where(amax > 0, amax / 127.0, 1.0)
    q4 = jnp.clip(jnp.round(b4 / scales[:, None, :, None]),
                  -127, 127).astype(jnp.int8)
    scale_rows = jnp.broadcast_to(
        scales[:, :, None], (nbr, K, bs)).reshape(nbr, K * bs)
    diag = op.diagonal().astype(jnp.float32).reshape(nbr, bs)
    return QuantizedBandedOperator(q4.reshape(nbr, bs, K * bs), scale_rows,
                                   diag, bandwidth=bw, backend=op.backend)


def generate_banded_bsr_quantized(n_block_rows: int, bs: int,
                                  bandwidth: int = 1,
                                  coupling: float = 1e-3, seed: int = 0,
                                  backend: str = "auto",
                                  ) -> QuantizedBandedOperator:
    """Generate + int8-quantize entirely on the HOST.

    ``quantize_banded_int8(generate_banded_bsr(...))`` stages the full
    f32 block table on the device first — 15.4 GB at the 10M-row
    north-star shape. This constructor runs the identical assembly and
    quantization math in numpy so only the int8 blocks + f32
    scales/diagonal ship to the device (4x smaller).
    Bit-identical to the device path (pinned by tests/test_quantized.py).
    """
    rng = np.random.default_rng(seed)
    dt = np.float32
    nbr, bw = n_block_rows, bandwidth
    K = 2 * bw + 1
    require(nbr >= K, OperatorError,
            f"need at least K={K} block rows for bandwidth {bw}")
    # Identical assembly to generate_banded_bsr (kept in (nbr, K, bs, bs)
    # band-slot-major form — the quantizer's natural axis order).
    vals = np.zeros((nbr, K, bs, bs), dt)
    for d in range(1, bw + 1):
        cnt = nbr - d
        if cnt <= 0:
            continue
        blocks = (rng.random((cnt, bs, bs)).astype(dt) - 0.5) * coupling
        r = np.arange(cnt)
        vals[r, bw + d] = blocks
        vals[r + d, bw - d] = blocks.transpose(0, 2, 1)
    dblocks = (rng.random((nbr, bs, bs)).astype(dt) - 0.5) * coupling
    dblocks = dblocks + dblocks.transpose(0, 2, 1)
    diag = np.arange(1, nbr * bs + 1, dtype=dt).reshape(nbr, bs)
    idx = np.arange(bs)
    dblocks[:, idx, idx] = diag
    vals[:, bw] = dblocks

    # Identical quantization math to quantize_banded_int8, numpy-side.
    # b4[r, i, k, j] == vals[r, k, i, j] (the stored row-major block
    # layout); zero the center slot's diagonal for the off-split.
    # Copy: transpose returns a VIEW, and the diagonal zeroing must not
    # mutate ``vals`` (which a future caller may want unquantized).
    b4 = vals.transpose(0, 2, 1, 3).copy()
    b4[:, idx, bw, idx] = 0.0
    amax = np.max(np.abs(b4), axis=(1, 3))              # (nbr, K)
    scales = np.where(amax > 0, amax / dt(127.0), dt(1.0)).astype(dt)
    q4 = np.clip(np.round(b4 / scales[:, None, :, None]),
                 -127, 127).astype(np.int8)
    scale_rows = np.broadcast_to(
        scales[:, :, None], (nbr, K, bs)).reshape(nbr, K * bs)
    return QuantizedBandedOperator(q4.reshape(nbr, bs, K * bs),
                                   np.ascontiguousarray(scale_rows), diag,
                                   bandwidth=bw, backend=backend)


@jax.tree_util.register_pytree_node_class
class HybridBandedOperator(LinearOperator):
    """Band + remainder split of an unstructured sparse operator.

    Unstructured row gathers run orders of magnitude below streaming
    reads, but physically meaningful operators concentrate their mass
    near the diagonal. This operator applies the near-diagonal part
    through the DIA banded path and only the off-band remainder through
    the ELL gather path:

        A = Band(A)  +  Remainder(A)
            (streaming)   (gathers, but only the tail)

    Build with :func:`split_band_remainder`.
    """

    def __init__(self, band: BSROperator, remainder=None, perm=None):
        # ``remainder``: ELLOperator or SlicedELLOperator (or None).
        require(remainder is None or band.shape == remainder.shape,
                OperatorError, "band/remainder shapes differ")
        self.band = band
        self.remainder = remainder
        # Optional row/column reordering (e.g. RCM): the operator
        # represents P A Pᵀ; perm[i] = original index at new position i.
        # Solve in the reordered space, then map vectors back with
        # :meth:`unpermute`.
        self.perm = None if perm is None else jnp.asarray(perm, jnp.int32)

    @property
    def shape(self):
        return self.band.shape

    @property
    def dtype(self):
        return self.band.dtype

    @property
    def band_fraction(self) -> float:
        """Fraction of stored values captured by the banded part (host)."""
        band_nnz = float(np.count_nonzero(np.asarray(self.band.blocks)))
        rem_nnz = (0.0 if self.remainder is None
                   else float(self.remainder.nnz))
        total = band_nnz + rem_nnz
        return band_nnz / total if total else 1.0

    def matmat(self, block):
        out = self.band.matmat(block)
        if self.remainder is not None:
            out = out + self.remainder.matmat(block)
        return out

    def matmat_ds(self, x_hi, x_lo):
        """Compensated DS apply: band and remainder DS partials combined
        with exact two_sum (both parts implement matmat_ds)."""
        from fortran_davidson_tpu.utils import ds as dsm
        bh, bl = self.band.matmat_ds(x_hi, x_lo)
        if self.remainder is None:
            return bh, bl
        rh, rl = self.remainder.matmat_ds(x_hi, x_lo)
        h, e = dsm.two_sum(bh, rh)
        return dsm.fast_two_sum(h, bl + rl + e)

    def diagonal(self):
        d = self.band.diagonal()
        if self.remainder is not None:
            d = d + self.remainder.diagonal()
        return d

    def to_dense(self):
        dense = self.band.to_dense()
        if self.remainder is not None:
            dense = dense + self.remainder.to_dense()
        return dense

    def offdiag(self) -> "HybridBandedOperator":
        rem = None if self.remainder is None else self.remainder.offdiag()
        return HybridBandedOperator(self.band.offdiag(), rem,
                                    perm=self.perm)

    def with_backend(self, backend: str) -> "HybridBandedOperator":
        return HybridBandedOperator(self.band.with_backend(backend),
                                    self.remainder, perm=self.perm)

    def unpermute(self, X):
        """Map vectors from the operator's (reordered, padded) row space
        back to the ORIGINAL ordering: returns ``(len(perm), ...)`` rows
        (reordering pads are dropped). No-op view when unordered."""
        if self.perm is None:
            return X
        n_orig = self.perm.shape[0]
        out_shape = (n_orig,) + X.shape[1:]
        return jnp.zeros(out_shape, X.dtype).at[self.perm].set(X[:n_orig])

    def tree_flatten(self):
        return (self.band, self.remainder, self.perm), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.band, obj.remainder, obj.perm = children
        return obj


def split_band_remainder(rows, cols, vals, n: int, *, block_size: int = 128,
                         bandwidth: int = 1, dtype=jnp.float64,
                         backend: str = "xla", chunk: int = 8,
                         pad_diag: Optional[float] = None,
                         block_rows_multiple: int = 1,
                         reorder: Optional[str] = None,
                         remainder_format: str = "sell"
                         ) -> HybridBandedOperator:
    """Split COO triplets into a DIA banded BSR part plus a sparse remainder.

    Entries with ``|i//bs - j//bs| <= bandwidth`` land in the banded part
    (dense ``bs x bs`` blocks, DIA-aligned slots — the Pallas kernel's
    layout); everything else goes to the padded-ELL remainder.
    ``n`` is padded up to a multiple of ``block_size`` internally; callers
    see the padded dimension via ``op.shape``.

    ``pad_diag`` sets the diagonal value of the padded tail rows. The
    default (``None``) places them strictly ABOVE the spectrum (twice the
    Gershgorin bound ``||A||_inf``, plus one) so a lowest-eigenvalue solve
    never reports a padding pair — padding inside the spectrum (e.g. the
    obvious 1.0) would silently displace true eigenpairs. Pass an explicit
    value when the operator is used as the B of a pencil (``pad_diag=1.0``
    keeps the pencil's padded block the identity).

    ``block_rows_multiple``: additionally pad so the number of BLOCK rows
    is a multiple of this — row-sharding over an N-device mesh needs the
    block rows divisible by N (pass ``block_rows_multiple=N``).

    ``reorder="rcm"``: apply a reverse Cuthill-McKee bandwidth-reducing
    permutation first (native C++, scipy fallback) — scattered patterns
    whose graph is narrow capture far more mass in the fast banded part.
    The returned operator represents ``P A Pᵀ``; map eigenvectors back
    with :meth:`HybridBandedOperator.unpermute` (the solved eigenVALUES
    are permutation-invariant).

    ``remainder_format``: ``"sell"`` (default) stores the off-band tail
    as a :class:`SlicedELLOperator` — rows sorted by stray-entry count
    into power-of-two-width buckets, so gather traffic scales with the
    remainder's ACTUAL nnz instead of ``n * max_row_nnz`` (remainders
    are skewed: a few rows hold most stray couplings). ``"ell"`` keeps
    the uniformly padded :class:`ELLOperator`.
    """
    require(remainder_format in ("sell", "ell"), OperatorError,
            f"unknown remainder_format {remainder_format!r} "
            "(supported: 'sell', 'ell')")
    bs = block_size
    bw = bandwidth
    K = 2 * bw + 1
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.dtype(jnp.dtype(dtype).name))
    perm = None
    if reorder is not None:
        require(reorder == "rcm", OperatorError,
                f"unknown reorder {reorder!r} (supported: 'rcm')")
        from fortran_davidson_tpu import native
        perm = native.rcm_order(rows, cols, n)
        require(perm is not None, OperatorError,
                "rcm reordering needs the native component or scipy")
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        rows = inv[rows]
        cols = inv[cols]
    quantum = bs * max(int(block_rows_multiple), 1)
    n_pad = -(-n // quantum) * quantum
    nbr = n_pad // bs
    require(nbr >= K, OperatorError,
            f"need at least {K} block rows for bandwidth {bw}")

    br = rows // bs
    bc = cols // bs
    in_band = np.abs(br - bc) <= bw

    # Banded part: DIA-aligned dense blocks.
    offs = np.arange(nbr)[:, None] - bw + np.arange(K)
    dia_cols = np.clip(offs, 0, nbr - 1).astype(np.int32)
    blocks = np.zeros((nbr, K, bs, bs), vals.dtype)
    rb, cb, vb = rows[in_band], cols[in_band], vals[in_band]
    slot = (cb // bs) - (rb // bs) + bw
    np.add.at(blocks, (rb // bs, slot, rb % bs, cb % bs), vb)
    # Padded tail of the diagonal: above-spectrum by default (see
    # docstring) so the spurious pairs sort strictly last.
    if n_pad > n:
        if pad_diag is None:
            row_abs = np.zeros(n, np.float64)
            np.add.at(row_abs, rows, np.abs(vals).astype(np.float64))
            pad_diag = 2.0 * float(row_abs.max(initial=0.0)) + 1.0
        pad_idx = np.arange(n, n_pad)
        blocks[pad_idx // bs, bw, pad_idx % bs, pad_idx % bs] += vals.dtype.type(pad_diag)
    band = BSROperator(
        dia_cols,
        np.ascontiguousarray(blocks.transpose(0, 2, 1, 3)).reshape(
            nbr, bs, K * bs),
        backend=backend, bandwidth=bw)

    # Remainder: whatever falls outside the block band.
    if np.any(~in_band):
        rem_cls = (SlicedELLOperator if remainder_format == "sell"
                   else ELLOperator)
        remainder = rem_cls.from_coo(rows[~in_band], cols[~in_band],
                                     vals[~in_band], n_pad,
                                     dtype=dtype, chunk=chunk)
    else:
        remainder = None
    return HybridBandedOperator(band, remainder, perm=perm)


def generate_local_sparse(n: int, nnz_per_row: int, locality: float = 200.0,
                          sparsity: float = 1e-3, seed: int = 0,
                          dtype=jnp.float64):
    """Random symmetric diagonal-dominant sparse matrix with *locality*:
    off-diagonal distance |i-j| ~ geometric(1/locality) — the structure of
    discretized physical operators, where most mass hugs the diagonal.
    Returns COO triplets ``(rows, cols, vals)`` (feed to
    :func:`split_band_remainder` or ``ELLOperator.from_coo``).
    """
    rng = np.random.default_rng(seed)
    dt = np.dtype(jnp.dtype(dtype).name)
    n_pairs = max(n * max(nnz_per_row - 1, 0) // 2, 0)
    i = rng.integers(0, n, n_pairs)
    d = rng.geometric(min(1.0 / max(locality, 1.0), 1.0), n_pairs)
    j = np.clip(i + d * rng.choice([-1, 1], n_pairs), 0, n - 1)
    keep = j != i
    i, j = i[keep], j[keep].astype(np.int64)
    v = rng.random(i.shape[0]).astype(dt) * sparsity
    rows = np.concatenate([i, j, np.arange(n)])
    cols = np.concatenate([j, i, np.arange(n)])
    vals = np.concatenate([v, v, np.arange(1, n + 1, dtype=dt)])
    return rows, cols, vals

"""Banded-BSR operator with explicit halo exchange (`shard_map` + ppermute).

The north-star workload is a 10M-row banded block-sparse matrix
row-partitioned over several devices. For that structure the generic sharded
gather (``parallel.sharded``) would all-gather the full ``(n, m)`` input
block even though each device only needs ``bandwidth * bs`` boundary rows
from each neighbor. This module is the explicit-collective alternative:

- each device owns a contiguous slab of block rows (operator tables and
  basis rows sharded identically);
- the SpMM under :func:`jax.shard_map` sends only the boundary slabs to
  the two ring neighbors with ``ppermute`` (neighbor traffic, which XLA
  hands to NCCL on GPUs — no all-gather), and
- the shard-local contraction runs on the halo-extended slab, through the
  Pallas kernel (``backend`` as for
  :class:`~fortran_davidson_tpu.ops.sparse.BSROperator`) or plain XLA.

The reference's entire analogue is the OpenMP row loop at
``src/davidson.f90:559-567``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from fortran_davidson_tpu.ops.operators import LinearOperator
from fortran_davidson_tpu.ops.pallas_kernels import (BACKENDS, banded_spmm,
                                                     kernel_mode,
                                                     kernel_supported)
from fortran_davidson_tpu.ops.sparse import (BSROperator,
                                             _quantized_dia_apply)
from fortran_davidson_tpu.parallel.mesh import ROWS_AXIS, row_sharding
from fortran_davidson_tpu.utils.errors import OperatorError, require


@jax.tree_util.register_pytree_node_class
class HaloBSROperator(LinearOperator):
    """Banded block-ELL operator applied with ring halo exchange.

    ``block_cols``/``blocks`` are the global block-ELL tables of
    :class:`~fortran_davidson_tpu.ops.sparse.BSROperator`, restricted to a
    band: every stored block's column must lie within ``bandwidth`` block
    rows of its own block row. Arrays are placed row-sharded on ``mesh``.
    """

    def __init__(self, block_cols, blocks, bandwidth: int, mesh: Mesh,
                 axis: str = ROWS_AXIS, backend: str = "xla",
                 _placed: bool = False):
        # blocks use the (nbr, bs, K*bs) row-major block layout of
        # :class:`~fortran_davidson_tpu.ops.sparse.BSROperator`.
        nbr, K = block_cols.shape[:2]
        ndev = mesh.shape[axis]
        require(nbr % ndev == 0, OperatorError,
                f"{nbr} block rows not divisible by {ndev} devices")
        nbr_local = nbr // ndev
        require(bandwidth <= nbr_local, OperatorError,
                f"bandwidth {bandwidth} exceeds local slab {nbr_local} — "
                "halo exchange only reaches ring neighbors")
        if not _placed:
            block_cols = jax.device_put(
                jnp.asarray(block_cols, jnp.int32),
                row_sharding(mesh, 2, axis))
            blocks = jax.device_put(jnp.asarray(blocks),
                                    row_sharding(mesh, 3, axis))
        require(backend in BACKENDS, OperatorError,
                f"unknown halo backend {backend!r}")
        self.block_cols = block_cols
        self.blocks = blocks
        self.bandwidth = int(bandwidth)
        self.mesh = mesh
        self.axis = axis
        self.backend = backend

    @classmethod
    def from_bsr(cls, op: BSROperator, bandwidth: int, mesh: Mesh,
                 axis: str = ROWS_AXIS,
                 backend: str = "xla") -> "HaloBSROperator":
        return cls(op.block_cols, op.blocks, bandwidth, mesh, axis,
                   backend=backend)

    # -- LinearOperator -------------------------------------------------
    @property
    def block_size(self) -> int:
        return self.blocks.shape[1]

    @property
    def shape(self):
        n = self.blocks.shape[0] * self.block_size
        return (n, n)

    @property
    def dtype(self):
        return self.blocks.dtype

    def matmat(self, block):
        nbr, bs, kbs = self.blocks.shape
        K = kbs // bs
        ndev = self.mesh.shape[self.axis]
        nbr_l = nbr // ndev
        bw = self.bandwidth
        axis = self.axis

        fwd = [(d, (d + 1) % ndev) for d in range(ndev)]
        bwd = [(d, (d - 1) % ndev) for d in range(ndev)]

        compute = (self.dtype if jnp.dtype(self.dtype).itemsize
                   < jnp.dtype(block.dtype).itemsize else block.dtype)
        # DIA storage: row r of the halo-extended local slab contracts at
        # offset r, so the single-device kernel applies unchanged per
        # shard.
        mode = kernel_mode(self.backend, kernel_supported(
            bs, K, bw, compute))

        def local_spmm_kernel(blks, x):
            halo = bw * bs
            from_prev = jax.lax.ppermute(x[-halo:], axis, fwd)
            from_next = jax.lax.ppermute(x[:halo], axis, bwd)
            x_ext = jnp.concatenate([from_prev, x, from_next])
            return banded_spmm(blks.astype(compute), x_ext, bandwidth=bw,
                               halo=True, out_dtype=x.dtype,
                               interpret=mode == "interpret")

        def local_spmm(cols, blks, x):
            # cols: (nbr_l, K) global block-column ids; x: (nbr_l*bs, m).
            i = jax.lax.axis_index(axis)
            m = x.shape[1]
            halo = bw * bs
            # Ring halo exchange: predecessor's bottom slab and successor's
            # top slab. Wrap-around slabs at the ring ends are never
            # referenced (band structure) — their contributions are masked.
            from_prev = jax.lax.ppermute(x[-halo:], axis, fwd)
            from_next = jax.lax.ppermute(x[:halo], axis, bwd)

            xb = x.reshape(nbr_l, bs, m)
            local_idx = cols - i * nbr_l                # in [-bw, nbr_l + bw)
            is_local = (local_idx >= 0) & (local_idx < nbr_l)

            # Interior contraction — independent of the ppermutes, so XLA
            # overlaps it with the neighbor transfers.
            gi = jnp.take(xb, jnp.clip(local_idx, 0, nbr_l - 1), axis=0)
            gi = gi * is_local[:, :, None, None].astype(x.dtype)
            out = jnp.einsum("rab,rbm->ram", blks.astype(x.dtype),
                             gi.reshape(nbr_l, -1, m),
                             preferred_element_type=x.dtype)

            # Halo contraction over the 2*bw received boundary blocks.
            xh = jnp.concatenate([from_prev, from_next]).reshape(
                2 * bw, bs, m)
            halo_idx = jnp.where(local_idx < 0, local_idx + bw,
                                 local_idx - nbr_l + bw)
            gh = jnp.take(xh, jnp.clip(halo_idx, 0, 2 * bw - 1), axis=0)
            gh = gh * (~is_local)[:, :, None, None].astype(x.dtype)
            out = out + jnp.einsum("rab,rbm->ram", blks.astype(x.dtype),
                                   gh.reshape(nbr_l, -1, m),
                                   preferred_element_type=x.dtype)
            return out.reshape(nbr_l * bs, m)

        spec2 = P(axis, None)
        if mode is not None:
            # check_vma=False: pallas_call outputs carry no varying-mesh
            # annotation yet.
            return jax.shard_map(
                local_spmm_kernel, mesh=self.mesh,
                in_specs=(P(axis, None, None), spec2),
                out_specs=spec2, check_vma=False,
            )(self.blocks, block)
        return jax.shard_map(
            local_spmm, mesh=self.mesh,
            in_specs=(spec2, P(axis, None, None), spec2),
            out_specs=spec2,
        )(self.block_cols, self.blocks, block)

    def diagonal(self):
        nbr, bs, kbs = self.blocks.shape
        b4 = self.blocks.reshape(nbr, bs, kbs // bs, bs)
        own = self.block_cols == jnp.arange(nbr, dtype=jnp.int32)[:, None]
        diag_blocks = jnp.sum(
            jnp.where(own[:, None, :, None], b4, 0), axis=2)
        return jnp.diagonal(diag_blocks, axis1=1, axis2=2).reshape(-1)

    def offdiag(self) -> "HaloBSROperator":
        """Exact off-diagonal split (sharding preserved: the mask is a
        shard-local elementwise where on the row-sharded tables)."""
        nbr, bs, kbs = self.blocks.shape
        K = kbs // bs
        i = jax.lax.broadcasted_iota(jnp.int32, (bs, kbs), 0)
        j = jax.lax.broadcasted_iota(jnp.int32, (bs, kbs), 1)
        in_block_diag = i == (j % bs)
        own = self.block_cols == jnp.arange(nbr, dtype=jnp.int32)[:, None]
        mask = own[:, None, :][:, :, (j // bs)[0]] & in_block_diag[None]
        return HaloBSROperator(self.block_cols,
                               jnp.where(mask, 0, self.blocks),
                               self.bandwidth, self.mesh, self.axis,
                               backend=self.backend, _placed=True)

    # -- pytree ----------------------------------------------------------
    def tree_flatten(self):
        return ((self.block_cols, self.blocks),
                (self.bandwidth, self.mesh, self.axis, self.backend))

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.block_cols, obj.blocks = children
        obj.bandwidth, obj.mesh, obj.axis, obj.backend = aux
        return obj


@jax.tree_util.register_pytree_node_class
class HaloQuantizedOperator(LinearOperator):
    """Row-sharded int8-quantized banded operator (halo exchange).

    The distributed face of
    :class:`~fortran_davidson_tpu.ops.sparse.QuantizedBandedOperator`:
    int8 off-diagonal blocks + per-slot f32 scales + exact f32 diagonal,
    all row-sharded; the SpMM ppermutes only the ``bandwidth * bs``
    boundary rows to the ring neighbors and contracts the halo-extended
    local slab — through the Pallas kernel (``backend="auto"``: on a GPU)
    or the plain DIA slot-sum.
    Same accuracy contract as the single-chip quantized operator
    (bf16-class; diagonal/offdiag exact).
    """

    def __init__(self, qblocks, scale_rows, diag, bandwidth: int,
                 mesh: Mesh, axis: str = ROWS_AXIS, backend: str = "auto",
                 _placed: bool = False):
        nbr, bs, kbs = qblocks.shape
        ndev = mesh.shape[axis]
        require(nbr % ndev == 0, OperatorError,
                f"{nbr} block rows not divisible by {ndev} devices")
        require(bandwidth <= nbr // ndev, OperatorError,
                f"bandwidth {bandwidth} exceeds local slab {nbr // ndev} — "
                "halo exchange only reaches ring neighbors")
        require(kbs == (2 * bandwidth + 1) * bs, OperatorError,
                "quantized halo needs DIA-aligned K == 2*bw+1 slots")
        require(backend in BACKENDS, OperatorError,
                f"unknown backend {backend!r}")
        if not _placed:
            qblocks = jax.device_put(jnp.asarray(qblocks, jnp.int8),
                                     row_sharding(mesh, 3, axis))
            scale_rows = jax.device_put(
                jnp.asarray(scale_rows, jnp.float32),
                row_sharding(mesh, 2, axis))
            diag = jax.device_put(jnp.asarray(diag, jnp.float32),
                                  row_sharding(mesh, 2, axis))
        self.qblocks = qblocks
        self.scale_rows = scale_rows
        self.diag = diag
        self.bandwidth = int(bandwidth)
        self.mesh = mesh
        self.axis = axis
        self.backend = backend

    @classmethod
    def from_quantized(cls, op, mesh: Mesh, axis: str = ROWS_AXIS,
                       backend: str | None = None):
        """Distribute a single-chip ``QuantizedBandedOperator``."""
        return cls(op.qblocks, op.scale_rows, op.diag, op.bandwidth,
                   mesh, axis,
                   backend=op.backend if backend is None else backend)

    # -- LinearOperator -------------------------------------------------
    @property
    def block_size(self) -> int:
        return self.qblocks.shape[1]

    @property
    def shape(self):
        n = self.qblocks.shape[0] * self.block_size
        return (n, n)

    @property
    def dtype(self):
        return self.scale_rows.dtype

    def matmat(self, block):
        nbr, bs, kbs = self.qblocks.shape
        K = kbs // bs
        ndev = self.mesh.shape[self.axis]
        nbr_l = nbr // ndev
        bw = self.bandwidth
        axis = self.axis

        fwd = [(d, (d + 1) % ndev) for d in range(ndev)]
        bwd = [(d, (d - 1) % ndev) for d in range(ndev)]
        mode = kernel_mode(self.backend,
                           kernel_supported(bs, K, bw, jnp.int8))

        def extend(x):
            halo = bw * bs
            from_prev = jax.lax.ppermute(x[-halo:], axis, fwd)
            from_next = jax.lax.ppermute(x[:halo], axis, bwd)
            return jnp.concatenate([from_prev, x, from_next])

        def local_q(qb, sr, dg, x):
            # The ring ends' wrapped halo slabs multiply zero
            # out-of-range blocks.
            if mode is None:
                return _quantized_dia_apply(qb, sr, dg, extend(x), bw,
                                            halo=True)
            return banded_spmm(qb, extend(x), sr, dg, bandwidth=bw,
                               halo=True, interpret=mode == "interpret")

        spec2 = P(axis, None)
        return jax.shard_map(
            local_q, mesh=self.mesh,
            in_specs=(P(axis, None, None), spec2, spec2, spec2),
            out_specs=spec2, check_vma=False,
        )(self.qblocks, self.scale_rows, self.diag, block)

    def diagonal(self):
        return self.diag.reshape(-1)

    def offdiag(self) -> "HaloQuantizedOperator":
        """Exact: the diagonal is stored separately — zero it out."""
        return HaloQuantizedOperator(
            self.qblocks, self.scale_rows, jnp.zeros_like(self.diag),
            self.bandwidth, self.mesh, self.axis, backend=self.backend,
            _placed=True)

    # -- pytree ----------------------------------------------------------
    def tree_flatten(self):
        return ((self.qblocks, self.scale_rows, self.diag),
                (self.bandwidth, self.mesh, self.axis, self.backend))

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.qblocks, obj.scale_rows, obj.diag = children
        obj.bandwidth, obj.mesh, obj.axis, obj.backend = aux
        return obj

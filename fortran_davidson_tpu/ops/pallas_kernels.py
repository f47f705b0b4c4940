"""Pallas (Triton route) kernel for the banded block-sparse SpMM.

The hot op of the solver is ``Y = A @ X`` with A a DIA-banded block-sparse
matrix (slot k of block row r holds the ``bs x bs`` block at block column
``r - bw + k``; out-of-range slots hold zero blocks) and X a tall block of
basis vectors. The plain XLA forms move more than the minimum bytes: the
gathered form writes and reads a ``(nbr, K*bs, m)`` buffer, the DIA
slot-sum writes and reads K partial ``(n, m)`` outputs, and int8 storage
may be dequantized into an f32 table first. This kernel reads each stored
block once, reads the x rows each block row needs, and writes y once:

- one program per (block row, tile of ``TR`` rows, tile of ``TM``
  columns); the K = 2*bw+1 band slots are looped inside the program;
- bf16 blocks run bf16 tensor-core dots with f32 accumulation;
- int8 blocks (the quantized off-diagonal part) are exact in bf16, so the
  f32 input is split into three bf16 words and contracted with three
  tensor-core dots (f32-grade products); the per-(row, slot) scale
  multiplies the slot's partial and the exact f32 diagonal is added in
  the epilogue;
- f32 blocks are not taken: a true-f32 (``allow_tf32=False``) Triton dot
  runs on CUDA cores and measured several times slower than XLA's f32
  GEMM (PERF.md);
- ``m`` is padded (in registers, by masked loads and stores) to a power
  of two >= 16, the smallest operand ``pl.dot`` accepts.

The same kernel serves the row-sharded path: there x is the shard's slab
extended by ``bw`` halo block rows on each side (``halo=True``), so every
slot's rows are in range.

``interpret=True`` runs the kernel under the Pallas interpreter (CPU
tests); it is only ever set by the caller. Which path an operator takes
is decided in :func:`kernel_mode`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from fortran_davidson_tpu.utils.errors import OperatorError

# Operator ``backend`` values: "auto" takes the compiled kernel on a GPU
# and the plain XLA path elsewhere; "pallas" demands the compiled kernel;
# "pallas-interpret" runs the same kernel under the Pallas interpreter.
BACKENDS = ("auto", "xla", "pallas", "pallas-interpret")

_KERNEL_DTYPES = (jnp.bfloat16, jnp.int8)

# Pallas's Triton lowering indexes a ref with 32-bit offsets unless the
# array exceeds 2**32 BYTES, so a 1-byte array of 2**31..2**32 elements
# overflows (a 10M-row int8 table is 3.8e9). Such tables are read as
# int16 byte pairs: half the elements, the two bytes split in registers.
_MAX_I32_ELEMENTS = 2**31


class KernelUnavailableError(OperatorError):
    """The compiled kernel was requested on a platform it cannot run on."""


def _pow2(v: int) -> bool:
    return v > 0 and v & (v - 1) == 0


def kernel_supported(bs: int, K: int, bandwidth, dtype) -> bool:
    """Shapes and storage the kernel handles: DIA-aligned band, a
    power-of-two block size >= 32 (``pl.dot`` operands are >= 16 on every
    side, and int8 pairs halve the block) and bf16 or int8 blocks. Other
    operators take the plain XLA path."""
    return (bandwidth is not None and K == 2 * bandwidth + 1
            and _pow2(bs) and bs >= 32
            and any(jnp.dtype(dtype) == jnp.dtype(d) for d in _KERNEL_DTYPES))


def kernel_mode(backend: str, supported: bool):
    """The one place that picks an operator's apply path.

    Returns ``None`` (plain XLA), ``"compiled"`` or ``"interpret"``.
    Raises :class:`KernelUnavailableError` when ``backend="pallas"`` asks
    for the compiled kernel off a GPU.
    """
    if backend not in BACKENDS:
        raise OperatorError(f"unknown backend {backend!r} "
                            f"(supported: {', '.join(BACKENDS)})")
    if backend == "xla" or not supported:
        return None
    if backend == "pallas-interpret":
        return "interpret"
    on_gpu = jax.default_backend() == "gpu"
    if backend == "pallas" and not on_gpu:
        raise KernelUnavailableError(
            "backend='pallas' needs a GPU (the kernel compiles through "
            f"Triton); this process runs on {jax.default_backend()!r}. "
            "Use backend='auto', 'xla' or 'pallas-interpret'.")
    return "compiled" if on_gpu else None


def _tiles(bs: int, m: int, kind: str):
    """Row tile TR and column tile TM (powers of two, >= 16)."""
    mp = max(16, pl.next_power_of_2(m))
    tm = min(mp, 64)
    tr = min(bs, 64 if kind == "int8" or tm <= 32 else 32)
    return tr, tm


def _split_bf16(x):
    """x (f32) as three bf16 words whose f32 sum carries x's 24 bits."""
    x1 = x.astype(jnp.bfloat16)
    r1 = x - x1.astype(jnp.float32)
    x2 = r1.astype(jnp.bfloat16)
    x3 = (r1 - x2.astype(jnp.float32)).astype(jnp.bfloat16)
    return x1, x2, x3


def _int8_tile(blocks_ref, r, rows, k, bs, TR, pairs):
    """Slot k's (TR, bs) int8 block tile as bf16 (int8 is exact in bf16).
    With ``pairs`` the table is int16 byte pairs: the low byte holds the
    even column and the high byte the odd one (little endian); joining
    them along a new minor axis restores the column order."""
    if not pairs:
        return blocks_ref[r, rows, pl.ds(k * bs, bs)].astype(jnp.bfloat16)
    w = blocks_ref[r, rows, pl.ds(k * bs // 2, bs // 2)]
    lo = jnp.right_shift(jnp.left_shift(w, 8), 8)   # sign-extended byte
    hi = jnp.right_shift(w, 8)
    q = jnp.concatenate([lo[:, :, None], hi[:, :, None]], axis=-1)
    return q.reshape(TR, bs).astype(jnp.bfloat16)


def _banded_kernel(*refs, K, bw, bs, TR, TM, m, nbx, shift, kind, pairs):
    if kind == "int8":
        blocks_ref, scale_ref, diag_ref, x_ref, y_ref = refs
    else:
        blocks_ref, x_ref, y_ref = refs
    r = pl.program_id(0)
    rows = pl.ds(pl.program_id(1) * TR, TR)
    c0 = pl.program_id(2) * TM
    cols = pl.ds(c0, TM)
    col_ok = (c0 + jnp.arange(TM) < m)[None, :]

    acc = jnp.zeros((TR, TM), jnp.float32)
    for k in range(K):
        xr = r + k - bw + shift                      # block row of x
        ok = (xr >= 0) & (xr < nbx)
        start = jnp.clip(xr, 0, nbx - 1) * bs
        xk = plgpu.load(x_ref.at[pl.ds(start, bs), cols],
                        mask=ok & col_ok, other=0.0).astype(jnp.float32)
        if kind == "int8":
            # x as three bf16 words keeps f32-grade products on the
            # tensor cores.
            q = _int8_tile(blocks_ref, r, rows, k, bs, TR, pairs)
            x1, x2, x3 = _split_bf16(xk)
            p = pl.dot(q, x3, allow_tf32=False)
            p = p + pl.dot(q, x2, allow_tf32=False)
            p = p + pl.dot(q, x1, allow_tf32=False)
            acc = acc + scale_ref[r, k * bs] * p
        else:
            a = blocks_ref[r, rows, pl.ds(k * bs, bs)]
            acc = acc + pl.dot(a, xk.astype(jnp.bfloat16), allow_tf32=False)
    if kind == "int8":
        ctr = (r + shift) * bs + pl.program_id(1) * TR
        xc = plgpu.load(x_ref.at[pl.ds(ctr, TR), cols], mask=col_ok,
                        other=0.0).astype(jnp.float32)
        acc = acc + diag_ref[r, rows][:, None] * xc
    plgpu.store(y_ref.at[pl.ds(r * bs + pl.program_id(1) * TR, TR), cols],
                acc.astype(y_ref.dtype), mask=col_ok)


@functools.partial(jax.jit, static_argnames=(
    "bandwidth", "halo", "out_dtype", "interpret", "pairs"))
def banded_spmm(blocks, x, scale_rows=None, diag=None, *, bandwidth: int,
                halo: bool = False, out_dtype=None, interpret: bool = False,
                pairs=None):
    """DIA-banded block-sparse SpMM ``Y = A @ X``.

    Args:
      blocks: (nbr, bs, K*bs) row-major block layout, K = 2*bandwidth+1,
        bf16 or int8 (int8: the quantized OFF-diagonal part).
      x: (nbr*bs, m); with ``halo=True`` ((nbr + 2*bandwidth)*bs, m), the
        rows framed by ``bandwidth`` halo block rows on each side.
      scale_rows: (nbr, K*bs) f32 per-slot scales (int8 only; the scale
        of slot k is read at lane ``k*bs``).
      diag: (nbr, bs) f32 exact matrix diagonal (int8 only).
      out_dtype: output dtype (defaults to ``x.dtype``).
      interpret: run under the Pallas interpreter.
      pairs: read int8 blocks as int16 byte pairs; ``None`` does so
        exactly when the table has 2**31 elements or more.

    Returns:
      (nbr*bs, m) array.
    """
    nbr, bs, kbs = blocks.shape
    K = kbs // bs
    bw = int(bandwidth)
    if not kernel_supported(bs, K, bw, blocks.dtype):
        raise OperatorError(
            f"banded_spmm needs K == 2*bw+1, a power-of-two block size "
            f">= 32 and bf16/int8 blocks; got blocks {blocks.shape} "
            f"{blocks.dtype}, bw={bw}")
    kind = "int8" if blocks.dtype == jnp.int8 else "bf16"
    if (kind == "int8") != (scale_rows is not None and diag is not None):
        raise OperatorError("int8 blocks need scale_rows and diag (and "
                            "only int8 blocks take them)")
    nbx = nbr + 2 * bw if halo else nbr
    if x.shape[0] != nbx * bs:
        raise OperatorError(f"x has {x.shape[0]} rows, expected {nbx * bs}")
    m = x.shape[1]
    out_dtype = jnp.dtype(x.dtype if out_dtype is None else out_dtype)
    TR, TM = _tiles(bs, m, kind)
    if pairs is None:
        pairs = kind == "int8" and blocks.size >= _MAX_I32_ELEMENTS
    item = jnp.dtype(blocks.dtype).itemsize
    if pairs:
        blocks = jax.lax.bitcast_convert_type(
            blocks.reshape(nbr, bs, kbs // 2, 2), jnp.int16)
    kernel = functools.partial(_banded_kernel, K=K, bw=bw, bs=bs, TR=TR,
                               TM=TM, m=m, nbx=nbx, shift=bw if halo else 0,
                               kind=kind, pairs=pairs)
    operands = ((blocks, scale_rows, diag, x) if kind == "int8"
                else (blocks, x))
    return pl.pallas_call(
        kernel,
        grid=(nbr, bs // TR, pl.cdiv(m, TM)),
        out_shape=jax.ShapeDtypeStruct((nbr * bs, m), out_dtype),
        interpret=interpret,
        compiler_params=plgpu.CompilerParams(num_warps=4,
                                             num_stages=1),
        cost_estimate=pl.CostEstimate(
            flops=2 * nbr * K * bs * bs * m * (3 if kind == "int8" else 1),
            bytes_accessed=(nbr * bs * kbs * item + nbx * bs * m * x.itemsize
                            + nbr * bs * m * out_dtype.itemsize),
            transcendentals=0),
        name="banded_spmm",
    )(*operands)

"""Double-single (two-float) compensated arithmetic.

f32 storage and arithmetic move half the bytes of float64 (and some
accelerators have no fast float64 at all). The reference computes
everything in real64 (``/root/reference/src/numeric_kinds.f90:10``) and
its 1e-8 tolerances assume it. This module provides the error-free
transformations (Dekker/Knuth) and the *chunked compensated reductions*
that let the solver reach 1e-6..1e-8 accuracy on f32 hardware:

- ``two_sum`` / ``two_prod``: exact a+b / a*b as a (value, error) pair of
  f32s — branch-free elementwise code (Dekker splitting; no FMA
  dependence).
- double-single scalars/arrays represented as a ``(hi, lo)`` pair with
  ``|lo| <= ulp(hi)``: ~48-bit effective mantissa (eps ~ 4e-15).
- ``gram_ds``: the workhorse. A naive f32 Gram V^T V over n=10M rows
  carries a stochastic ~sqrt(n)*eps ~ 2e-4 accumulation error — the
  measured f32 convergence floor of round 1. Chunking the row axis into
  c-row batched matmuls and combining the n/c partial Grams with an
  exact two_sum tree bounds each rounding to its chunk's LOCAL magnitude:
  total error ~ eps * c / sqrt(n) (≈ 8e-8 at c=4096, n=1e7) — f64-grade
  accuracy at full matmul speed (the combine is O(n/c * m^2) flops).

Everything is jit-safe, shard-safe (reductions stay per-chunk until the
final tree, which XLA lowers to log-depth elementwise adds), and works in
any float dtype (tests exercise f32 against an f64 oracle).
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp


class DS(NamedTuple):
    """A double-single number/array: value ``hi + lo`` with |lo| <= ulp(hi)."""

    hi: jnp.ndarray
    lo: jnp.ndarray

    def to_float(self):
        return self.hi + self.lo


def ds(hi, lo=None) -> DS:
    hi = jnp.asarray(hi)
    return DS(hi, jnp.zeros_like(hi) if lo is None else jnp.asarray(lo))


# -- error-free transformations ------------------------------------------

def two_sum(a, b):
    """Knuth two-sum: s = fl(a+b), e exact error (a+b = s+e). 6 flops."""
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e


def fast_two_sum(a, b):
    """Dekker fast two-sum; REQUIRES |a| >= |b| (or a == 0). 3 flops."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    """Split into hi/lo mantissa halves by BITMASKING (f32: 12+12 bits).

    The classic Dekker split (``t = c*a; hi = t - (t - a)``) depends on
    every intermediate being rounded exactly as written; compiler value
    transformations in large fused modules were observed to corrupt it
    on XLA:CPU at the default optimization level (two_prod error terms
    off by ~eps·|ab|, which surfaced as in-solve polish residuals
    fixed-pointing at eps·λ while the identical math compiled standalone
    — or under ``--xla_backend_optimization_level=0`` — reached 1e-13).
    Truncating the low mantissa bits via an integer mask is immune to
    any floating-point rewrite: ``hi`` is exact by construction,
    ``a - hi`` is exact (same exponent, trailing bits only), and the
    split widths keep every two_prod partial product representable
    (f32: 12+12 of the 24-bit significand; f64: 26+27 — the al*bl term
    may round by one ulp², the standard non-FMA two_prod caveat).
    """
    if a.dtype == jnp.float32:
        mask = jnp.uint32(0xFFFFF000)          # drop 12 low mantissa bits
        hi = jax.lax.bitcast_convert_type(
            jax.lax.bitcast_convert_type(a, jnp.uint32) & mask, a.dtype)
    else:
        mask = jnp.uint64(0xFFFFFFFFF8000000)  # drop 27 low mantissa bits
        hi = jax.lax.bitcast_convert_type(
            jax.lax.bitcast_convert_type(a, jnp.uint64) & mask, a.dtype)
    return hi, a - hi


def two_prod(a, b):
    """Dekker two-product: p = fl(a*b), e exact error (a*b = p+e)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# -- double-single arithmetic --------------------------------------------

def ds_add(x: DS, y: DS) -> DS:
    """DS + DS (Dekker add2: ~11 flops, |error| ~ eps^2)."""
    s, e = two_sum(x.hi, y.hi)
    e = e + (x.lo + y.lo)
    return DS(*fast_two_sum(s, e))


def ds_neg(x: DS) -> DS:
    return DS(-x.hi, -x.lo)


def ds_sub(x: DS, y: DS) -> DS:
    return ds_add(x, ds_neg(y))


def ds_mul(x: DS, y: DS) -> DS:
    """DS * DS."""
    p, e = two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    return DS(*fast_two_sum(p, e))


def ds_mul_f(x: DS, a) -> DS:
    """DS * plain float."""
    p, e = two_prod(x.hi, a)
    e = e + x.lo * a
    return DS(*fast_two_sum(p, e))


def ds_div(x: DS, y: DS) -> DS:
    """DS / DS via Newton-corrected quotient."""
    q1 = x.hi / y.hi
    r = ds_sub(x, ds_mul_f(y, q1))
    q2 = (r.hi + r.lo) / y.hi
    return DS(*fast_two_sum(q1, q2))


def ds_sqrt(x: DS) -> DS:
    """sqrt of a DS (one Newton step on the f32 sqrt)."""
    s = jnp.sqrt(x.hi)
    # guard exact zeros (s == 0 -> division); sqrt(0) = 0 exactly.
    safe = jnp.where(s > 0, s, 1.0)
    r = ds_sub(x, DS(*two_prod(s, s)))
    corr = jnp.where(s > 0, (r.hi + r.lo) / (2.0 * safe), 0.0)
    return DS(*fast_two_sum(s, corr))


# -- compensated reductions ----------------------------------------------

# Summation strategy for the TALL (row axis ~ 10^6..10^7) reductions.
#
# "cascade" (default): a sequential ``fori_loop`` of exact two_sum slab
# accumulations over contiguous row slabs. One streaming read of the
# inputs, no relayout (the tree path's cost is dominated by TWO
# (n, k) -> (n/g, 128) relayout copies, not by the tree).
#
# "tree": the original log-depth two_sum tree. Required under GSPMD row
# sharding: the cascade's ``dynamic_slice`` over the sharded row axis
# would make the partitioner materialize cross-shard gathers every loop
# step, while the tree's elementwise levels partition cleanly. The
# sharded engine selects it via :func:`sum_strategy`.
#
# Both orders are error-free transformations of the same sum — accuracy
# class is identical (~eps² relative); bit-level results differ.
_SUM_STRATEGY: contextvars.ContextVar = contextvars.ContextVar(
    "ds_sum_strategy", default="cascade")

# Device count along the sharded row axis (1 = unsharded). Under GSPMD
# the tree reductions reshape their leading axis to (D, rows/D, ...) and
# pair WITHIN axis 1 only: every tree level is then elementwise on
# shard-local rows, and only the final (D, width) partial crosses the
# mesh. Without this, the contiguous-halves pairing folds the top half
# of a row-sharded array onto the bottom half — the first level alone
# permutes HALF THE ARRAY across devices (measured: ~10.7 MB of n-scale
# collective-permute per sharded iteration at n=16k, growing linearly
# with n; shard-local pairing leaves only the n-independent halo + Gram
# collectives). Error-free transform: any pairing order carries its
# roundings in the lo channel, so the accuracy class is unchanged (bits
# differ from the D=1 order; sharded-vs-single-device trajectory tests
# compare iteration counts, not bits).
_ROW_DIVISOR: contextvars.ContextVar = contextvars.ContextVar(
    "ds_row_divisor", default=1)

# Slab rows per cascade step. Big enough that the ~150-step loop
# amortizes XLA loop overhead at n=10M; small enough that the (B, k)
# accumulator pair stays small.
_CASCADE_SLAB = 65536
# Below this row count the tree is at least as fast and keeps small
# (CPU test-scale) problems on the historical code path.
_CASCADE_MIN_ROWS = 4 * _CASCADE_SLAB


@contextlib.contextmanager
def sum_strategy(name: str, row_divisor: int = 1):
    """Select the tall-reduction strategy for code traced in this scope.

    ``"cascade"`` (single-device streaming loop) or ``"tree"``
    (GSPMD-safe log-depth tree). ``row_divisor`` > 1 additionally makes
    the tree reductions pair shard-locally and the chunked Grams size
    their chunks to divide the per-shard row count (see
    ``_ROW_DIVISOR``). Trace-time: wrap the ``jax.jit`` CALL that
    traces the consuming code, not the runtime execution.
    """
    if name not in ("cascade", "tree"):
        raise ValueError(f"unknown ds sum strategy {name!r}")
    token = _SUM_STRATEGY.set(name)
    token_d = _ROW_DIVISOR.set(max(int(row_divisor), 1))
    try:
        yield
    finally:
        _SUM_STRATEGY.reset(token)
        _ROW_DIVISOR.reset(token_d)


def _use_cascade(n: int) -> bool:
    return (_SUM_STRATEGY.get() == "cascade"
            and n >= _CASCADE_MIN_ROWS)


def _cascade_fold(slab_fn, n: int, width: int, dtype, B: int) -> DS:
    """Compensated column sums via a sequential slab cascade.

    ``slab_fn(start, size)`` returns the (size, width) ``(hi, lo)``
    contribution of rows [start, start+size) — typically dynamic slices
    of the inputs with the elementwise error-free products applied
    in-loop (so the (n, width) product arrays never materialize in HBM).
    Accumulator position (i, j) exactly two_sums rows i, i+B, i+2B, ...
    of column j; every rounding error lands in the lo channel. The final
    (B, width) pair folds through the tree (n is tiny there).
    """
    nslab = n // B
    hi0 = jnp.zeros((B, width), dtype)

    def body(i, carry):
        hi, lo = carry
        sh, sl = slab_fn(i * B, B)
        s, e = two_sum(hi, sh)
        return s, lo + (sl + e)

    hi, lo = jax.lax.fori_loop(0, nslab, body, (hi0, hi0))
    rem = n - nslab * B
    if rem:
        sh, sl = slab_fn(nslab * B, rem)
        s, e = two_sum(hi[:rem], sh)
        hi = hi.at[:rem].set(s)
        lo = lo.at[:rem].add(sl + e)
    return _tall_sum_tree(hi, lo)


def _slice(x, start, size):
    return jax.lax.dynamic_slice_in_dim(x, start, size, axis=0)

def _fold_leading(hi, lo):
    """Two_sum tree-fold of axis 0 down to one entry (no final renorm).

    Pairs CONTIGUOUS halves. Any pairing is an error-free transform of
    the same sum (every rounding lands in the lo channel); XLA:CPU at its
    default optimization level was observed to MISCOMPILE the strided
    ``hi[0::2]/hi[1::2]`` form when fused into a large module (in-solve
    polish residuals corrupted at eps·λ), which contiguous halves avoid.

    Under GSPMD row sharding (``_ROW_DIVISOR`` D > 1, leading axis
    divisible by D) the fold is SHARD-LOCAL: reshape to (D, r/D, ...),
    tree WITHIN axis 1 (pure elementwise on each device's rows), then an
    exact sequential cascade over the D per-shard partials — only the
    (D, width) partial ever crosses the mesh. A cross-shard pairing
    would instead permute half the array across devices at the first
    level alone (see ``_ROW_DIVISOR``).
    """
    D = _ROW_DIVISOR.get()
    r = hi.shape[0]
    if D > 1 and r >= D and r % D == 0:
        hi = hi.reshape(D, r // D, *hi.shape[1:])
        lo = lo.reshape(D, r // D, *lo.shape[1:])
        while hi.shape[1] > 1:
            k = hi.shape[1]
            half = (k + 1) // 2
            if half * 2 - k:
                z = jnp.zeros_like(hi[:, :1])
                hi = jnp.concatenate([hi, z], axis=1)
                lo = jnp.concatenate([lo, z], axis=1)
            a, b = (hi[:, :half], hi[:, half:])
            la, lb = (lo[:, :half], lo[:, half:])
            s, e = two_sum(a, b)
            hi = s
            lo = la + lb + e
        hi, lo = hi[:, 0], lo[:, 0]
        h_acc, l_acc = hi[0], lo[0]
        for i in range(1, D):  # exact cascade over per-shard partials
            h_acc, err = two_sum(h_acc, hi[i])
            l_acc = l_acc + lo[i] + err
        return h_acc, l_acc
    while hi.shape[0] > 1:
        k = hi.shape[0]
        half = (k + 1) // 2
        if half * 2 - k:
            hi = jnp.concatenate([hi, jnp.zeros_like(hi[:1])])
            lo = jnp.concatenate([lo, jnp.zeros_like(lo[:1])])
        a, b = hi[:half], hi[half:]
        la, lb = lo[:half], lo[half:]
        s, e = two_sum(a, b)
        hi = s
        lo = la + lb + e
    return hi[0], lo[0]


def ds_sum_tree(x, axis: int = 0, lo=None) -> DS:
    """Exact-compensated sum along ``axis`` via a two_sum binary tree.

    Rounding errors at every node are carried in the lo channel (added in
    plain f32 — their own rounding is O(eps^2) relative). Cost: log2(k)
    elementwise passes over the array (total traffic ~2x the input).
    ``lo`` seeds the error channel — pass per-element exact product
    errors (two_prod) for Dot2-grade fully compensated dot products.
    Shard-local under GSPMD (see :func:`_fold_leading`).
    """
    x = jnp.moveaxis(jnp.asarray(x), axis, 0)
    hi = x
    lo = (jnp.zeros_like(x) if lo is None
          else jnp.moveaxis(jnp.asarray(lo), axis, 0))
    return DS(*fast_two_sum(*_fold_leading(hi, lo)))


def tall_sum_ds(x, lo=None) -> DS:
    """Exact-compensated column sums of a TALL (n, m) array pair.

    Strategy-dispatched (see :func:`sum_strategy`): the default cascade
    streams the pair once through a sequential slab loop; the tree path
    (GSPMD / small n) reshapes to a full-lane ``(n/g, g*m)`` layout and
    runs the log-depth two_sum tree. All orders are error-free — the
    accuracy class (~eps² relative) is identical; bits differ.
    """
    x = jnp.asarray(x)
    lo = jnp.zeros_like(x) if lo is None else jnp.asarray(lo)
    n, m = x.shape
    if _use_cascade(n):
        return _cascade_fold(
            lambda s, c: (_slice(x, s, c), _slice(lo, s, c)),
            n, m, x.dtype, _CASCADE_SLAB)
    return _tall_sum_tree(x, lo)


def _tall_sum_tree(x, lo) -> DS:
    """Log-depth two_sum tree on a full-lane reshaped layout.

    Arrays with a narrow minor dimension (m << 128) can be padded
    ~128/m-fold in tiled layouts, so a tree walking (n, m) arrays pays
    that bloat at every level. The pair is reshaped to ``(n/g, g*m)``
    (g = 128/m strata interleaved), the tree runs on compact rows, and the g strata
    per column fold with an exact sequential cascade at the end.
    """
    n, m = x.shape
    mp = 1
    while mp < m:
        mp *= 2
    if mp <= 128:
        g = 128 // mp
        if mp != m:
            x = jnp.pad(x, ((0, 0), (0, mp - m)))
            lo = jnp.pad(lo, ((0, 0), (0, mp - m)))
        if n % g:
            pad = g - n % g
            x = jnp.pad(x, ((0, pad), (0, 0)))
            lo = jnp.pad(lo, ((0, pad), (0, 0)))
            n = n + pad
        hi2 = x.reshape(n // g, g * mp)
        lo2 = lo.reshape(n // g, g * mp)
        # Contiguous-half pairing, shard-local under GSPMD — see
        # _fold_leading for both the miscompilation note and the
        # row-sharded (D, r/D) split.
        hi1, lo1 = _fold_leading(hi2, lo2)
        s = hi1.reshape(g, mp)
        e = lo1.reshape(g, mp)
        hi_acc, lo_acc = s[0], e[0]
        for i in range(1, g):  # exact cascade over the strata (g <= 128)
            hi_acc, err = two_sum(hi_acc, s[i])
            lo_acc = lo_acc + e[i] + err
        out = DS(*fast_two_sum(hi_acc, lo_acc))
        return DS(out.hi[:m], out.lo[:m])
    return ds_sum_tree(x, axis=0, lo=lo)


def _chunk(n: int, chunk: Optional[int]) -> int:
    if chunk is None:
        chunk = 4096
    while n % chunk and chunk > 1:
        chunk //= 2
    chunk = max(chunk, 1)
    # Under GSPMD row sharding the chunk must additionally divide the
    # per-shard row count — a chunk straddling a shard boundary makes
    # the (n, m) -> (n/c, c, m) reshape feeding the batched Gram an
    # n-scale cross-device reshard instead of a local-block split.
    D = _ROW_DIVISOR.get()
    if D > 1 and n % D == 0:
        local = n // D
        while chunk > 1 and local % chunk:
            chunk //= 2
    return chunk


def _chunk_sharded(n: int, row_divisor: int) -> int:
    """Chunk size that also divides the per-shard row count.

    Row-sharded chunked carries need every (c-row) chunk to live whole
    inside one shard: with ``n`` rows over ``row_divisor`` devices, ``c``
    must divide ``n // row_divisor`` so the (n/c, c, m) layout's leading
    axis partitions on chunk boundaries. Equals what :func:`_chunk`
    returns inside a ``sum_strategy(..., row_divisor=...)`` scope — this
    form is for trace-setup code that runs outside the scope.
    """
    c = _chunk(n, None)
    local = n // max(row_divisor, 1)
    while c > 1 and local % c:
        c //= 2
    return c


def gram_ds(V, W=None, *, chunk: Optional[int] = None) -> DS:
    """Compensated Gram matrix ``V^T W`` (W defaults to V) as a DS pair.

    The row axis is cut into ``chunk``-row slabs; each slab's partial Gram
    is a batched matmul in the working dtype, and the slab results are
    combined with the exact two_sum tree. Only the accumulation ACROSS
    chunks is removed; within a chunk the partial rounds like any f32
    GEMM. Measured on an NVIDIA H100 at n = 2**22, 24 columns (f32,
    relative to max|G|): columns with a common offset (1 + 0.1 N(0, 1)),
    where the across-chunk sum dominates, 8.1e-8 against 8.5e-7 for a
    plain f32 Gram; zero-mean random columns 1.1e-6 against 4.0e-6
    (PERF.md). ``chunk`` is reduced to divide n (the default 4096
    handles all power-of-two-ish padded shapes).

    NOTE: the (n, m) -> (n/c, c, m) reshape feeding the batched einsum
    can be a physical relayout of the operand; the chunked carry layout
    (``DavidsonOptions.carry_layout``) stores the carries pre-chunked
    so it never appears.
    """
    W = V if W is None else W
    n, m = V.shape
    p = W.shape[1]
    c = _chunk(n, chunk)
    Vc = V.reshape(n // c, c, m)
    Wc = W.reshape(n // c, c, p)
    return gram_ds_pre(Vc, Wc)


def gram_ds_pre(Vc, Wc=None) -> DS:
    """Compensated Gram on PRE-CHUNKED ``(n/c, c, m)`` operands.

    Bit-identical to :func:`gram_ds` on the flat arrays when ``c``
    matches (same einsum, same tree) — but with no ``(n, m) ->
    (n/c, c, m)`` reshape in the graph. The chunked-carry engine
    (``carry_layout="chunked"``) stores the tall basis/caches in this
    layout permanently, so the per-iteration relayout copy never
    happens: the array is already in the layout the Gram
    consumes.
    """
    Wc = Vc if Wc is None else Wc
    # precision=HIGHEST: a default that demotes f32 operands (TF32)
    # would put a 2^-11 floor under everything.
    partial = jnp.einsum("kcm,kcp->kmp", Vc, Wc,
                         preferred_element_type=Vc.dtype,
                         precision=jax.lax.Precision.HIGHEST)
    return ds_sum_tree(partial, axis=0)


def col_sumsq_ds(X, *, chunk: Optional[int] = None) -> DS:
    """Compensated per-column sum of squares (residual/vector norms)."""
    n, m = X.shape
    c = _chunk(n, chunk)
    Xc = X.reshape(n // c, c, m)
    partial = jnp.einsum("kcm,kcm->km", Xc, Xc,
                         preferred_element_type=X.dtype,
                         precision=jax.lax.Precision.HIGHEST)
    return ds_sum_tree(partial, axis=0)


def col_norms_ds(X, *, chunk: Optional[int] = None):
    """Compensated per-column 2-norms (plain float result)."""
    return ds_sqrt(col_sumsq_ds(X, chunk=chunk)).to_float()


def dot_cols_ds(X, Y) -> DS:
    """Fully compensated per-column dots diag(X^T Y) (Dot2 quality).

    Unlike :func:`gram_ds` (chunked matmuls — right for positive-dominant
    Gram sums), this pays for exact elementwise products (two_prod) and
    exact summation, so it stays accurate even under heavy cancellation
    (Rayleigh numerators ``x^T (A - σB) x``, deflation overlaps). Pure
    elementwise work; use on (n, k) column blocks, not wide bases. On the
    cascade strategy the products are formed inside the slab loop — the (n, k)
    product/error arrays never hit HBM.
    """
    n, k = X.shape
    if _use_cascade(n):
        def slab(s, c):
            return two_prod(_slice(X, s, c), _slice(Y, s, c))
        return _cascade_fold(slab, n, k, X.dtype, _CASCADE_SLAB)
    p, e = two_prod(X, Y)
    return tall_sum_ds(p, lo=e)


def weighted_dot_cols_ds(d, X, Y=None, extra_lo=None) -> DS:
    """Fully compensated ``Σ_i d_i X_ij Y_ij`` per column (Y defaults X).

    BOTH multiplications use two_prod — a plain f32 product of the
    near-unit terms (d x)·x would round at eps*|d x²| per element, and
    when the weighted sum dominates a Rayleigh quotient that single
    rounding becomes an eps-relative error on the eigenvalue.
    ``extra_lo`` adds a per-element first-order term (e.g. the x_lo
    cross terms of a double-single iterate). Fused in-loop on the
    cascade strategy.
    """
    Y = X if Y is None else Y
    n, k = X.shape

    def terms(dv, xv, yv, ev):
        p, e = two_prod(dv[:, None], xv)
        q, eq = two_prod(p, yv)
        lo = eq + e * yv
        if ev is not None:
            lo = lo + ev
        return q, lo

    if _use_cascade(n):
        def slab(s, c):
            return terms(_slice(d, s, c), _slice(X, s, c),
                         _slice(Y, s, c),
                         None if extra_lo is None
                         else _slice(extra_lo, s, c))
        return _cascade_fold(slab, n, k, X.dtype, _CASCADE_SLAB)
    q, lo = terms(d, X, Y, extra_lo)
    return tall_sum_ds(q, lo=lo)


def col_sumsq_pair_ds(hi, lo) -> DS:
    """Compensated per-column ``Σ (hi+lo)²`` of a DS column block.

    Evaluates ``Σ hi² + 2 Σ hi∘lo`` with the squares exact (two_prod)
    and the cross term folded into the error channel (|lo| <= ulp(hi)
    makes the lo² term ~eps⁴ — ignored). One fused pass on the cascade
    strategy; the residual-norm hot path of the refined/polish loops.
    """
    n, k = hi.shape

    def slab_terms(hs, ls):
        p, e = two_prod(hs, hs)
        return p, e + 2.0 * (hs * ls)

    if _use_cascade(n):
        def slab(s, c):
            return slab_terms(_slice(hi, s, c), _slice(lo, s, c))
        return _cascade_fold(slab, n, k, hi.dtype, _CASCADE_SLAB)
    p, e = slab_terms(hi, lo)
    return tall_sum_ds(p, lo=e)


# -- compensated elementwise kernels used by the solver -------------------

def shifted_diag_apply(diag, shift, X):
    """Compute ``(diag - shift)[:, None] * X`` in double-single.

    The heart of the high-precision residual for diagonal-dominant
    operators: near convergence ``diag_i ≈ shift`` where the eigenvector
    has its mass, and the f32 subtraction+product would leave an
    eps*|diag| error — exactly the term that dominates ``||Ax - λx||``.
    Returns a DS (n, k) pair (hi + lo).

    diag: (n,), shift: (k,), X: (n, k).
    """
    d, e_sub = two_sum(diag[:, None], -shift[None, :])
    p, e_mul = two_prod(d, X)
    return DS(*fast_two_sum(p, e_mul + e_sub * X))

"""Collective audit of the compiled row-sharded program.

Every heavy term of a Davidson iteration is row-local (operator apply,
corrections, CGS projections, basis updates — they scale 1/N); the only
cross-device traffic should be (a) the halo ``collective-permute`` of
``bandwidth * bs * m`` input rows per operator apply and (b) Gram / norm
``all-reduce`` of m_max-scale matrices — both INDEPENDENT of n. This
module reads the collective inventory of the compiled sharded stepper
(on the N-virtual-device CPU mesh, where GSPMD inserts the same
collectives it does on GPUs) and fails loudly if any collective moves an
n-scale array; the strongest form (:func:`assert_n_independent`)
compiles the program at TWO row counts and requires byte-identical
inventories.

The audit caught a real pathology: the DS tree reductions'
contiguous-halves pairing folded the top half of every row-sharded tall
array onto the bottom half, permuting HALF THE ARRAY across the mesh per
tree level (linear in n). Shard-local pairing
(``utils.ds._fold_leading``) keeps the per-iteration collectives
n-independent.

Reference analogue: the reference's entire parallel inventory is one
OpenMP row loop (``/root/reference/src/davidson.f90:559-567``).
"""

from __future__ import annotations

import re

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s32": 4, "u32": 4,
    "s8": 1, "u8": 1, "pred": 1, "s64": 8, "u64": 8, "c64": 8,
    "c128": 16,
}

_COLLECTIVES = ("all-reduce", "collective-permute", "all-gather",
                "reduce-scatter", "all-to-all")

# Collective op token (async `-start`/`-done` variants included) and the
# result shape groups preceding it. Async pairs: count the `-start` (it
# names the payload, possibly as a tuple whose extra u32[] context adds
# 4 noise bytes), skip the `-done`. Operands in HLO text are bare
# `%name` references, so every `dtype[dims]` before the op token
# belongs to the result.
_OP_RE = re.compile(
    r"\s((?:" + "|".join(_COLLECTIVES) + r")(?:-start|-done)?)\(")
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([\d,]*)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def collective_stats(hlo_text: str) -> dict:
    """Collective-op inventory of an optimized HLO module.

    Returns total bytes and per-kind (count, bytes, largest shapes).
    Bytes are the RESULT shapes of the collective ops — for all-reduce
    this equals the payload each chip contributes; for
    collective-permute, the shard-to-neighbor message size.
    """
    kinds: dict = {}
    largest: list = []
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if not m or "=" not in line[:m.start()]:
            continue
        op = m.group(1)
        if op.endswith("-done"):
            continue
        if op.endswith("-start"):
            op = op[:-len("-start")]
        shapes = [(dt, dims) for dt, dims
                  in _SHAPE_RE.findall(line[:m.start()])
                  # u32[]/s32[] scalars in async tuple results are DMA
                  # context handles, not wire payload.
                  if not (dims == "" and dt in ("u32", "s32"))]
        b = sum(_shape_bytes(dt, dims) for dt, dims in shapes)
        entry = kinds.setdefault(op, {"count": 0, "bytes": 0})
        entry["count"] += 1
        entry["bytes"] += b
        desc = "+".join(f"{dt}[{dims}]" for dt, dims in shapes[:3])
        largest.append((b, f"{desc} {op}"))
    largest.sort(reverse=True)
    return {
        "total_bytes": sum(e["bytes"] for e in kinds.values()),
        "total_count": sum(e["count"] for e in kinds.values()),
        "by_kind": kinds,
        "largest": [f"{b}B {s}" for b, s in largest[:8]],
        "max_single_bytes": largest[0][0] if largest else 0,
    }


def audit_no_tall_collectives(stats: dict, n_local: int, m_max: int,
                              itemsize: int = 4,
                              slack: float = 1.0) -> None:
    """Fail if any single collective moves an n-scale array.

    Row locality means no collective payload grows with the LOCAL row
    count beyond the halo slab. Threshold: one
    full local carry panel ``n_local * m_max * itemsize`` (times
    ``slack``) — a GSPMD all-gather/reshard of a tall array would exceed
    it immediately, while halos (bw*bs*m) and Gram blocks (m_max²) sit
    orders below at production scale. The cap is floored at
    ``32 * m_max²`` elements so legitimate m-scale payloads (variadic
    all-reduce tuples of Gram partials) never trip it on the toy-n
    probe shapes, where n_local can be smaller than m_max²; the
    rigorous guard against n-scaling is :func:`assert_n_independent`.
    """
    cap = max(slack * n_local * m_max * itemsize,
              32 * m_max * m_max * itemsize)
    if stats["max_single_bytes"] >= cap:
        raise AssertionError(
            f"compiled sharded program moves an n-scale collective: "
            f"{stats['largest'][:3]} (cap {cap:.0f}B) — the "
            "program's row-locality assumption is violated")


def probe_compiled_collectives(n_devices: int = 8, nbr: int = 128,
                               bs: int = 128, k: int = 20,
                               max_dim_sub: int = 44,
                               refined: bool = True) -> dict:
    """Compile the sharded north-star-shaped program on a CPU mesh and
    return its collective inventory.

    The collective payloads (halo slabs ``bw*bs*m``, Gram blocks
    ``m_max²``) are independent of the row count, so this small-n
    compile measures the SAME per-iteration traffic as the 10M-row
    target; the audit asserts that independence holds.
    """
    import jax

    from fortran_davidson_tpu.config import (DavidsonOptions,
                                             resolve_options)
    from fortran_davidson_tpu.core.loop import get_stepper
    from fortran_davidson_tpu.ops.sparse import (
        generate_banded_bsr_quantized)
    from fortran_davidson_tpu.parallel.mesh import default_mesh
    from fortran_davidson_tpu.parallel.sharded import (RowShardConstraint,
                                                       shard_operator)

    mesh = default_mesh(n_devices)
    op = shard_operator(
        generate_banded_bsr_quantized(nbr, bs, bandwidth=1,
                                      coupling=1e-3), mesh)
    n = op.shape[0]
    opts = DavidsonOptions(method="DPR", tolerance=1e-8,
                           relative_tolerance=True, dtype="float32",
                           expansion="lowest-k", max_dim_sub=max_dim_sub,
                           refined=refined,
                           final_polish=3 if refined else 0,
                           max_iterations=120)
    cfg = resolve_options(opts, k, n, generalized=False, sharded=True,
                          shard_row_divisor=n_devices)
    constrain = RowShardConstraint(mesh)
    init, step = get_stepper(cfg, constrain)
    with mesh:
        A_off = op.offdiag() if refined else None
        st = init(op, None)
        lowered = step.lower(op, None, st, A_off, None)
    text = lowered.compile().as_text()
    stats = collective_stats(text)
    stats["n"] = n
    stats["n_local"] = n // n_devices
    stats["m_max"] = cfg.m_max
    stats["n_devices"] = n_devices
    return stats


def assert_n_independent(stats_small: dict, stats_large: dict) -> None:
    """Require byte-identical collective inventories at two row counts.

    Every cross-chip payload of a row-sharded Davidson iteration (halo
    slabs, Gram/norm partials) is independent of n; if doubling n moves
    a single extra collective byte, some tall array is being resharded
    and the 1/N work model is wrong. This is the strongest form of the
    audit — it caught the round-5 tall-tree resharding (see module
    docstring).
    """
    a, b = stats_small, stats_large
    if (a["total_bytes"], a["total_count"]) != (b["total_bytes"],
                                               b["total_count"]):
        raise AssertionError(
            "collective traffic scales with n: "
            f"n={a['n']}: {a['total_bytes']}B/{a['total_count']} ops vs "
            f"n={b['n']}: {b['total_bytes']}B/{b['total_count']} ops; "
            f"largest at large n: {b['largest'][:3]}")

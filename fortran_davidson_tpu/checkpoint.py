"""Checkpoint / resume for long solves (orbax-backed).

The reference has no persistence at all — its only "restart" is the
in-memory basis collapse (``src/davidson.f90:218,438``) and its only file
I/O is test text dumps. For long runs this framework checkpoints
the full solver state pytree ``(V, AV[, BV], iteration, convergence
masks, history)`` every N iterations and resumes bit-exactly: the loop
state is explicit (``core.loop.init_state``), so a restored solve
continues exactly where it stopped — same iterates, same iteration
count, no re-applied operators.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Optional

import jax

from fortran_davidson_tpu.config import (DavidsonOptions, DavidsonResult,
                                         merge_options, resolve_options)
from fortran_davidson_tpu.core.loop import get_stepper, run_chunked
from fortran_davidson_tpu.ops.operators import as_operator
from fortran_davidson_tpu.utils.dtypes import canonical_dtype
from fortran_davidson_tpu.utils.errors import (InvalidOptionsError,
                                               MissingDependencyError,
                                               OperatorError, require)

_STEP_RE = re.compile(r"^step_(\d+)$")
_CONFIG_FILE = "solver_config.json"


def _config_fingerprint(cfg, n: int) -> dict:
    fp = dataclasses.asdict(cfg)
    fp["n"] = int(n)
    return fp


def write_config_fingerprint(directory: str, cfg, n: int) -> None:
    os.makedirs(os.path.abspath(directory), exist_ok=True)
    path = os.path.join(os.path.abspath(directory), _CONFIG_FILE)
    with open(path, "w") as f:
        json.dump(_config_fingerprint(cfg, n), f, indent=1, sort_keys=True)


def _saved_fingerprint(directory: str) -> Optional[dict]:
    path = os.path.join(os.path.abspath(directory), _CONFIG_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def check_config_fingerprint(directory: str, cfg, n: int) -> None:
    """Raise a CLEAR error when resuming with a different configuration.

    Checkpoint shapes are bound to the configuration (history buffers
    sized by max_iterations, basis width by the subspace schedule);
    without this check a mismatched resume surfaces as an opaque orbax
    shape error at best — or silently wrong semantics (e.g. a different
    tolerance) at worst.
    """
    saved = _saved_fingerprint(directory)
    if saved is None:
        return  # pre-fingerprint checkpoint: fall through to orbax checks
    now = _config_fingerprint(cfg, n)
    diffs = {key: (saved.get(key), now[key]) for key in now
             if saved.get(key) != now[key]}
    require(not diffs, InvalidOptionsError,
            "checkpoint was written with a different solver configuration; "
            "resume with the SAME options or point at a fresh directory. "
            f"Mismatched (saved, requested): {diffs}")


def _step_dirs(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = _step_dirs(directory)
    return steps[-1][0] if steps else None


def _orbax():
    """``orbax.checkpoint``, imported on first use (optional dependency)."""
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise MissingDependencyError(
            "checkpointing needs orbax: pip install orbax-checkpoint") from e
    return ocp


def save_state(directory: str, state: dict) -> str:
    """Write the solver state pytree as ``step_<it>`` under ``directory``."""
    ocp = _orbax()

    step = int(state["it"])
    path = os.path.join(os.path.abspath(directory), f"step_{step}")
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(path, state, force=True)
    return path


def restore_state(directory: str, template: dict,
                  step: Optional[int] = None) -> Optional[dict]:
    """Restore the latest (or given) ``step_*`` checkpoint; None if absent.

    ``template`` supplies the pytree structure/shardings — use the
    stepper's ``init(A, B)`` output (or ``jax.eval_shape`` thereof).
    """
    ocp = _orbax()

    steps = _step_dirs(os.path.abspath(directory))
    if not steps:
        return None
    if step is not None:
        match = [p for s, p in steps if s == step]
        require(match, OperatorError, f"no checkpoint step_{step} found")
        path = match[0]
    else:
        path = steps[-1][1]
    abstract = jax.tree.map(ocp.utils.to_shape_dtype_struct, template)
    with ocp.StandardCheckpointer() as ckptr:
        return ckptr.restore(path, abstract)


def _attach_shardings(template: dict, mesh) -> dict:
    """ShapeDtypeStructs of the state template with explicit NamedShardings
    on ``mesh``: tall state arrays row-sharded, everything else replicated.
    Restoring through this template reshards the checkpoint onto the
    CURRENT topology regardless of the topology that saved it."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fortran_davidson_tpu.parallel.mesh import ROWS_AXIS
    from fortran_davidson_tpu.parallel.sharded import _SHARDED_STATE_KEYS

    out = {}
    for key, leaf in template.items():
        if key in _SHARDED_STATE_KEYS and leaf.ndim >= 1:
            spec = P(ROWS_AXIS, *([None] * (leaf.ndim - 1)))
        else:
            spec = P()
        out[key] = jax.ShapeDtypeStruct(
            leaf.shape, leaf.dtype, sharding=NamedSharding(mesh, spec))
    return out


def eigensolve_checkpointed(matrix, lowest: int, directory: str,
                            every: int = 10, second_matrix=None,
                            resume: bool = True, mesh=None,
                            options: Optional[DavidsonOptions] = None,
                            callbacks=(), initial_vectors=None,
                            **overrides) -> DavidsonResult:
    """Davidson solve that checkpoints every ``every`` iterations.

    Same contract as :func:`fortran_davidson_tpu.solver.eigensolve`; when
    ``resume`` and ``directory`` holds a ``step_*`` checkpoint, the solve
    continues from it instead of starting over. Checkpoints are
    shape-bound to the solver configuration (the history buffers are
    sized by ``max_iterations``): resume with the SAME options that wrote
    the checkpoint.

    With ``mesh``, the solve runs row-sharded
    (:func:`~fortran_davidson_tpu.parallel.sharded.eigensolve_sharded`
    semantics) and orbax persists/restores the sharded state — the
    long-run combination the checkpointing exists for.
    """
    opts = merge_options(options, overrides)
    dt = canonical_dtype(opts.dtype)

    constrain = None
    A = as_operator(matrix, dtype=dt)
    B = None if second_matrix is None else as_operator(second_matrix, dtype=dt)
    if mesh is not None:
        from fortran_davidson_tpu.parallel.sharded import (RowShardConstraint,
                                                           shard_operator)
        A = shard_operator(A, mesh)
        B = None if B is None else shard_operator(B, mesh)
        constrain = RowShardConstraint(mesh)
    require(A.shape[0] == A.shape[1], OperatorError, "A must be square")
    cfg = resolve_options(opts, lowest, A.shape[0], generalized=B is not None,
                          sharded=constrain is not None)

    state = None
    if resume and latest_step(directory) is not None:
        # Resume must adopt the carry layout the checkpoint was WRITTEN
        # with: the carry shapes differ between layouts ((n, m) flat vs
        # (n/c, c, m) chunked), so a layout drift — e.g. the "auto"
        # default now resolving differently than when the run started —
        # would otherwise fail the fingerprint check (or the orbax
        # restore) opaquely. Only an explicit "auto" is rebound; an
        # explicit flat/chunked request still fails loudly on mismatch.
        saved = _saved_fingerprint(directory)
        if (opts.carry_layout == "auto" and saved is not None
                and saved.get("carry_layout") in ("flat", "chunked")
                and saved["carry_layout"] != cfg.carry_layout
                # chunked carries are single-device; a mesh resume of a
                # chunked checkpoint must fail the fingerprint check
                # loudly rather than crash inside run_state.
                and not (constrain is not None
                         and saved["carry_layout"] == "chunked")):
            cfg = dataclasses.replace(cfg,
                                      carry_layout=saved["carry_layout"])
        check_config_fingerprint(directory, cfg, A.shape[0])
    init, _ = get_stepper(cfg, constrain)
    if resume and latest_step(directory) is not None:
        template = jax.eval_shape(lambda: init(A, B))
        if mesh is not None:
            # Attach the CURRENT mesh's shardings so orbax reshards on
            # load — a resume may run on a different topology than
            # the one that wrote the checkpoint (fewer/more hosts after
            # an elastic restart); without explicit shardings orbax
            # falls back to the sharding file recorded at save time,
            # which references the OLD device set.
            template = _attach_shardings(template, mesh)
        state = restore_state(directory, template)
    write_config_fingerprint(directory, cfg, A.shape[0])

    def save_cb(st):
        save_state(directory, st)

    # Validate ALWAYS (a malformed argument should raise on resume runs
    # too, not only once the checkpoint directory is empty); the warm
    # start is USED only for fresh solves — a restored checkpoint
    # already carries its basis.
    from fortran_davidson_tpu.config import validate_initial_vectors
    X0 = validate_initial_vectors(initial_vectors, A.shape[0],
                                  cfg.init_dim, dt)
    if state is not None:
        X0 = None
    if X0 is not None and mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        from fortran_davidson_tpu.parallel.mesh import ROWS_AXIS
        X0 = jax.device_put(X0, NamedSharding(mesh, P(ROWS_AXIS, None)))
    return run_chunked(cfg, A, B, every=every,
                       callbacks=(save_cb, *callbacks), state=state,
                       constrain=constrain, X0=X0)

"""Multi-host initialization and mesh construction.

The replacement for a distributed communication backend the
reference never had (SURVEY.md §2: no MPI/NCCL/Gloo — single process).
On a multi-host job every host runs the same program:

    from fortran_davidson_tpu.parallel import multihost
    mesh = multihost.initialize()          # jax.distributed + global mesh
    res = eigensolve_sharded(A, k, mesh)   # collectives ride NVLink/network

``initialize`` is a no-op on single-process setups (tests, one host), so
library code can call it unconditionally.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
from jax.sharding import Mesh

from fortran_davidson_tpu.parallel.mesh import ROWS_AXIS, default_mesh

_initialized = False


def _multihost_env_hints() -> list:
    """Environment evidence that this process is part of a multi-process
    launch (so a failed ``jax.distributed.initialize()`` is a real
    misconfiguration, not a benign single-process fall-through)."""
    hints = [name for name in ("JAX_COORDINATOR_ADDRESS",
                               "MEGASCALE_COORDINATOR_ADDRESS",
                               "JAX_NUM_PROCESSES")
             if os.environ.get(name)]
    for name in ("SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE", "PMI_SIZE"):
        val = os.environ.get(name)
        if val and val.isdigit() and int(val) > 1:
            hints.append(name)
    return hints


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               axis: str = ROWS_AXIS) -> Mesh:
    """Initialize multi-host JAX (idempotent) and return the global mesh.

    With no arguments, relies on ``jax.distributed.initialize()``'s
    cluster auto-detection; where none exists, pass
    ``coordinator_address``, ``num_processes`` and ``process_id``.
    ``initialize`` must be the process's FIRST JAX touch: probing the
    backend (even ``jax.process_count()``) before distributed init would
    initialize the local backend, after which distributed init is
    unsupported — so no such probe happens here. Single-process
    environments (no coordinator discoverable, or a backend already up in
    tests) fall through to a local-device mesh.
    """
    global _initialized
    if not _initialized:
        if coordinator_address is not None:
            jax.distributed.initialize(coordinator_address=coordinator_address,
                                       num_processes=num_processes,
                                       process_id=process_id)
        else:
            try:
                jax.distributed.initialize()
            except (ValueError, RuntimeError) as e:
                # Benign for genuine single-process runs (no coordinator
                # discoverable / backend already up in tests) AND for the
                # standard pattern where the CALLER already ran
                # jax.distributed.initialize() itself — distributed state
                # is then up and the global mesh below is correct. Only
                # when the environment says multi-process AND distributed
                # init is genuinely absent would a silent local-mesh
                # fallback give every process an inconsistent mesh —
                # hangs or wrong collectives with no signal. Fail loud.
                already_up = getattr(jax.distributed, "is_initialized",
                                     lambda: False)()
                hints = _multihost_env_hints()
                if hints and not already_up:
                    raise RuntimeError(
                        "jax.distributed.initialize() failed in what "
                        f"looks like a multi-process launch ({'/'.join(hints)} "
                        "set); refusing to fall back to a local mesh"
                    ) from e
        _initialized = True
    return default_mesh(axis=axis)


def is_coordinator() -> bool:
    """True on the process that should write checkpoints/logs."""
    return jax.process_index() == 0


def global_mesh(axis: str = ROWS_AXIS) -> Mesh:
    """1-D mesh over every device in the job (all hosts)."""
    return default_mesh(axis=axis)

"""Device-mesh helpers.

The reference is a single-process library whose entire parallelism is one
OpenMP row loop (``src/davidson.f90:559-567``); this framework scales by
row-partitioning the operator and the tall basis over a
``jax.sharding.Mesh``. Conventions:

- the solver's distribution axis is named ``"rows"`` (the analogue of the
  reference's OpenMP row loop);
- the subspace axis is never sharded — Gram matrices and the projected
  eigenproblem are tiny and solved replicated on every device, exactly as
  the scaling recipe demands (psum the products, replicate the solve).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ROWS_AXIS = "rows"


def default_mesh(n_devices: Optional[int] = None,
                 axis: str = ROWS_AXIS,
                 devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` available devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devices)} present")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def row_sharding(mesh: Mesh, ndim: int, axis: str = ROWS_AXIS) -> NamedSharding:
    """NamedSharding that splits the leading (row) dimension of an
    ``ndim``-dimensional array across ``axis``."""
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())

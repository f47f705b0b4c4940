"""fortran_davidson_tpu — a block-Davidson eigensolver for accelerators.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of
NLESC-JCER/Fortran_Davidson: lowest-k eigenpairs of diagonal-dominant
symmetric (generalized) eigenproblems via block Davidson with DPR or GJD
corrections, over dense, sparse, or matrix-free operators, single-chip or
sharded across a device mesh.
"""

from fortran_davidson_tpu.batched import eigensolve_batched
from fortran_davidson_tpu.checkpoint import eigensolve_checkpointed
from fortran_davidson_tpu.config import DavidsonOptions, DavidsonResult
from fortran_davidson_tpu.core.loop import (clear_compiled_caches,
                                            set_compiled_cache_capacity)
from fortran_davidson_tpu.ops.operators import (
    DenseOperator,
    DiagonalOperator,
    LinearOperator,
    MatrixFreeOperator,
    as_operator,
    from_element_fn,
)
from fortran_davidson_tpu.scipy_compat import eigsh
from fortran_davidson_tpu.ops.sparse import (BSROperator, ELLOperator,
                                              SlicedELLOperator)
from fortran_davidson_tpu.solver import (eigensolve,
                                         generalized_eigensolver,
                                         polish_eigenpairs)

__version__ = "0.5.0"

__all__ = [
    "BSROperator",
    "DavidsonOptions",
    "DavidsonResult",
    "DenseOperator",
    "DiagonalOperator",
    "ELLOperator",
    "SlicedELLOperator",
    "eigsh",
    "LinearOperator",
    "MatrixFreeOperator",
    "as_operator",
    "clear_compiled_caches",
    "eigensolve",
    "eigensolve_batched",
    "eigensolve_checkpointed",
    "from_element_fn",
    "generalized_eigensolver",
    "polish_eigenpairs",
    "set_compiled_cache_capacity",
    "__version__",
]

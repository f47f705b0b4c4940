"""Error contract for the framework.

The reference aborts with the failing routine's name on any LAPACK
``info /= 0`` (``src/lapack_wrapper.f90:395-408``). This framework keeps the
same *contract* — loud, named failures — but raises Python exceptions at
trace/validation time and uses in-graph guards (see
:func:`fortran_davidson_tpu.utils.dtypes.safe_denominator`) for runtime
numerics that the compiled program must survive.
"""

from __future__ import annotations


class DavidsonError(RuntimeError):
    """Base class for solver errors."""


class InvalidOptionsError(DavidsonError, ValueError):
    """Raised when solver options are inconsistent.

    Replaces the reference's silent undefined behavior on an unknown
    correction ``method`` string (``src/davidson.f90:653-669`` switches on
    the raw ``method`` instead of the defaulted local, yielding
    uninitialized corrections). We validate and raise instead.
    """


class OperatorError(DavidsonError, ValueError):
    """Raised for malformed linear operators (shape/dtype/symmetry issues)."""


class NumericalError(DavidsonError, ArithmeticError):
    """Raised when a numerical routine produced non-finite results — the
    eager equivalent of the reference's ``check_lapack_call`` abort
    (``src/lapack_wrapper.f90:395-408``)."""


class MissingDependencyError(DavidsonError, ImportError):
    """An optional package a feature needs is not installed."""


def require(cond: bool, exc_type: type, msg: str) -> None:
    if not cond:
        raise exc_type(msg)

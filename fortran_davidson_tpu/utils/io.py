"""Text I/O helpers (reference test-utility parity).

The reference's test harness persists vectors/matrices as whitespace
text files and reads them back (``src/tests/test_utils.f90:118-167``:
``read_matrix``, ``write_vector``, ``write_matrix``); its Python
cross-checks parse those files. This framework keeps the same
plain-text interchange format (one matrix row per line, whitespace
separated, C ordering) so fixtures round-trip with numpy and with the
reference's own dumps.
"""

from __future__ import annotations

import numpy as np


def write_vector(path, vector) -> None:
    """Write a 1-D vector as whitespace-separated text (one line)."""
    arr = np.asarray(vector).reshape(1, -1)
    np.savetxt(path, arr)


def write_matrix(path, matrix) -> None:
    """Write a 2-D matrix as text, one row per line."""
    np.savetxt(path, np.asarray(matrix))


def read_vector(path, dtype=np.float64):
    return np.loadtxt(path, dtype=dtype).reshape(-1)


def read_matrix(path, dtype=np.float64):
    """Read a whitespace-text matrix (``src/tests/test_utils.f90:118-135``)."""
    arr = np.loadtxt(path, dtype=dtype)
    return np.atleast_2d(arr)

"""Small host-side utilities: timing, matrix IO and the compile cache path.

Counterparts of the reference's SimpleTimer and matrix CSV writers
(reference: DPGO_utils.h:23-47, DPGO_utils.cpp:48-98).
"""

from __future__ import annotations

import os
import time
from typing import Mapping, Optional

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir(environ: Mapping[str, str] = os.environ) -> str:
    """JAX's persistent compile-cache directory: $JAX_COMPILATION_CACHE_DIR
    when set, else the fixed in-repo `.jax_cache`. The path is part of the
    cache key, so it never depends on a temporary name, a pid or the time."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        REPO_ROOT, ".jax_cache"
    )


class SimpleTimer:
    """Wall-clock millisecond timer (reference: DPGO_utils.cpp:48-68).

    Note for device work: wrap the timed region's outputs in
    jax.block_until_ready() before toc(), or the async dispatch makes the
    measurement meaningless.
    """

    def __init__(self):
        self._t0: Optional[float] = None

    def tic(self) -> None:
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        assert self._t0 is not None, "tic() before toc()"
        return (time.perf_counter() - self._t0) * 1e3

    @staticmethod
    def Tic() -> float:
        return time.perf_counter()

    @staticmethod
    def Toc(t0: float) -> float:
        return (time.perf_counter() - t0) * 1e3


def write_matrix_to_file(M, filename: str) -> None:
    """Full-precision CSV matrix dump (reference: DPGO_utils.cpp:70-80)."""
    np.savetxt(filename, np.asarray(M), delimiter=", ", fmt="%.17g")


def write_sparse_entries_to_file(rows, cols, values, filename: str) -> None:
    """row,col,value triplet dump (reference: DPGO_utils.cpp:82-98)."""
    with open(filename, "w") as f:
        for r, c, v in zip(rows, cols, values):
            f.write(f"{r},{c},{v}\n")

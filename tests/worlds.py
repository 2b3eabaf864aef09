"""Seeded pose-graph worlds for the tests.

The bundled reference .g2o files are not shipped with the repo, so tests run
on generated worlds of the same shapes: `datasets.synthesize_grid3d` at 9
and 125 poses (the tinyGrid3D and smallGrid3D sizes). Every third loop
closure is stored reversed (tail > head), as some edges of the grid files
are, so the backward-edge paths run too. Values the tests compare against
come from the f64 oracles on these worlds, never from the files.
"""

import dataclasses
import functools

import numpy as np

from dpgo_tpu.datasets import synthesize_grid3d

TINY = 9
SMALL = 125


def _reversed(m):
    """The same relative pose measured from the other end."""
    return dataclasses.replace(
        m, p1=m.p2, p2=m.p1, R=m.R.T.copy(), t=-(m.R.T @ m.t)
    )


@functools.lru_cache(maxsize=None)
def grid_world(num_poses: int, seed: int = 1):
    """(measurements, num_poses) of a seeded SE(3) grid world."""
    edges, n, _ = synthesize_grid3d(num_poses, seed=seed)
    meas = []
    lc = 0
    for m in edges.to_measurements():
        if m.p2 - m.p1 != 1:
            if lc % 3 == 0:
                m = _reversed(m)
            lc += 1
        meas.append(m)
    return tuple(meas), n

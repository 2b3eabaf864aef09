"""Relative SE(d) measurements: scalar struct and struct-of-arrays forms.

The reference stores measurements as an array-of-structs
(include/DPGO/RelativeSEMeasurement.h). Here we keep a light host-side
struct for protocol-level bookkeeping and convert to a struct-of-arrays
(`EdgeArrays`) before any computation, so every edge-parallel op is a batched
array op.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class RelativeSEMeasurement:
    """A relative SE(d) measurement from (r1, p1) to (r2, p2).

    Mirrors reference include/DPGO/RelativeSEMeasurement.h:21-71:
    rotation R (d x d), translation t (d,), rotation precision kappa,
    translation precision tau, GNC weight in [0, 1], fixed-weight flag.
    """

    r1: int
    r2: int
    p1: int
    p2: int
    R: np.ndarray
    t: np.ndarray
    kappa: float
    tau: float
    weight: float = 1.0
    fixed_weight: bool = False

    def __post_init__(self):
        self.R = np.asarray(self.R, dtype=np.float64)
        self.t = np.asarray(self.t, dtype=np.float64).reshape(-1)

    @property
    def d(self) -> int:
        return int(self.t.shape[0])

    def copy(self) -> "RelativeSEMeasurement":
        return RelativeSEMeasurement(
            self.r1, self.r2, self.p1, self.p2,
            self.R.copy(), self.t.copy(),
            self.kappa, self.tau, self.weight, self.fixed_weight,
        )


@dataclasses.dataclass
class EdgeArrays:
    """Struct-of-arrays form of a list of measurements (numpy, host-side).

    Shapes for m edges in dimension d:
      r1, r2, p1, p2 : (m,) int32
      R              : (m, d, d)
      t              : (m, d)
      kappa, tau     : (m,)
      weight         : (m,)
      fixed_weight   : (m,) bool
    """

    r1: np.ndarray
    r2: np.ndarray
    p1: np.ndarray
    p2: np.ndarray
    R: np.ndarray
    t: np.ndarray
    kappa: np.ndarray
    tau: np.ndarray
    weight: np.ndarray
    fixed_weight: np.ndarray

    @property
    def m(self) -> int:
        return int(self.p1.shape[0])

    @property
    def d(self) -> int:
        return int(self.t.shape[1]) if self.m > 0 else 0

    @staticmethod
    def from_measurements(
        measurements: Sequence[RelativeSEMeasurement], d: Optional[int] = None
    ) -> "EdgeArrays":
        m = len(measurements)
        if m == 0:
            if d is None:
                d = 3
            return EdgeArrays(
                r1=np.zeros(0, np.int32),
                r2=np.zeros(0, np.int32),
                p1=np.zeros(0, np.int32),
                p2=np.zeros(0, np.int32),
                R=np.zeros((0, d, d)),
                t=np.zeros((0, d)),
                kappa=np.zeros(0),
                tau=np.zeros(0),
                weight=np.zeros(0),
                fixed_weight=np.zeros(0, bool),
            )
        d = measurements[0].d
        return EdgeArrays(
            r1=np.array([mm.r1 for mm in measurements], np.int32),
            r2=np.array([mm.r2 for mm in measurements], np.int32),
            p1=np.array([mm.p1 for mm in measurements], np.int32),
            p2=np.array([mm.p2 for mm in measurements], np.int32),
            R=np.stack([mm.R for mm in measurements]),
            t=np.stack([mm.t for mm in measurements]),
            kappa=np.array([mm.kappa for mm in measurements]),
            tau=np.array([mm.tau for mm in measurements]),
            weight=np.array([mm.weight for mm in measurements]),
            fixed_weight=np.array([mm.fixed_weight for mm in measurements], bool),
        )

    def to_measurements(self) -> List[RelativeSEMeasurement]:
        return [
            RelativeSEMeasurement(
                int(self.r1[k]), int(self.r2[k]), int(self.p1[k]), int(self.p2[k]),
                self.R[k], self.t[k],
                float(self.kappa[k]), float(self.tau[k]),
                float(self.weight[k]), bool(self.fixed_weight[k]),
            )
            for k in range(self.m)
        ]


def num_poses_and_dim(
    measurements: Sequence[RelativeSEMeasurement],
) -> Tuple[int, int]:
    """Infer (dimension, num_poses) from measurements
    (reference: DPGO_utils.cpp:259-270)."""
    if not measurements:
        raise ValueError("empty measurement list")
    d = measurements[0].d
    n = 0
    for m in measurements:
        n = max(n, m.p1 + 1, m.p2 + 1)
    return d, n


def homogeneous(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Homogeneous (d+1)x(d+1) form [[R, t], [0, 1]] of an SE(d) element."""
    d = R.shape[-1]
    T = np.zeros(R.shape[:-2] + (d + 1, d + 1), dtype=R.dtype)
    T[..., :d, :d] = R
    T[..., :d, d] = t
    T[..., d, d] = 1.0
    return T


def measurement_error(
    m: RelativeSEMeasurement,
    R1: np.ndarray,
    t1: np.ndarray,
    R2: np.ndarray,
    t2: np.ndarray,
) -> float:
    """Squared measurement error kappa*||R1 R~ - R2||^2 + tau*||t2 - t1 - R1 t~||^2
    (reference: DPGO_utils.cpp:501-507)."""
    rot_err = float(np.sum((R1 @ m.R - R2) ** 2))
    tran_err = float(np.sum((t2.reshape(-1) - t1.reshape(-1) - R1 @ m.t) ** 2))
    return m.kappa * rot_err + m.tau * tran_err

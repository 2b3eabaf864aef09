"""Dense numpy oracles implementing the reference algorithms literally.

These re-derive the reference's data matrices with dense numpy, following
the *published algorithm* (SE-Sync connection Laplacian; reference:
DPGO_utils.cpp:272-344, PoseGraph.cpp:381-580) so the edge-based
operators can be validated against an independent construction.
"""

from __future__ import annotations

import numpy as np


def dense_connection_laplacian(measurements, num_poses: int) -> np.ndarray:
    """Q = A Omega A^T for private measurements, dense (d+1)n x (d+1)n
    (reference: DPGO_utils.cpp:272-344), summed edge by edge as
    sum_k A_k Omega_k A_k^T so no (d+1)n x (d+1)m incidence is formed."""
    d = measurements[0].d
    dh = d + 1
    Q = np.zeros((dh * num_poses, dh * num_poses))
    for meas in measurements:
        i, j = meas.p1, meas.p2
        T = np.zeros((dh, dh))
        T[:d, :d] = meas.R
        T[:d, d] = meas.t
        T[d, d] = 1.0
        om = np.full(dh, meas.weight * meas.kappa)
        om[d] = meas.weight * meas.tau
        # edge column block of A: -T at pose i, I at pose j
        Ak = {i: -T, j: np.eye(dh)}
        for a, Aa in Ak.items():
            for b, Ab in Ak.items():
                Q[a * dh:(a + 1) * dh, b * dh:(b + 1) * dh] += (Aa * om) @ Ab.T
    return Q


def dense_f(Xf: np.ndarray, Q: np.ndarray, G: np.ndarray) -> float:
    """f = 0.5 <X Q, X> + <X, G> with X in the flat r x (d+1)n layout
    (reference: QuadraticProblem.cpp:29-41)."""
    return 0.5 * np.sum((Xf @ Q) * Xf) + np.sum(Xf * G)


def dense_euc_grad(Xf: np.ndarray, Q: np.ndarray, G: np.ndarray) -> np.ndarray:
    return Xf @ Q + G


def flat(X: np.ndarray) -> np.ndarray:
    """(n, r, dh) -> (r, dh*n)."""
    n, r, dh = X.shape
    return np.transpose(X, (1, 0, 2)).reshape(r, n * dh)


def unflat(Xf: np.ndarray, n: int, d: int) -> np.ndarray:
    r = Xf.shape[0]
    return np.transpose(Xf.reshape(r, n, d + 1), (1, 0, 2))


def random_measurements(rng, n: int, d: int, extra_lc: int = 3):
    """A random connected pose chain + loop closures for testing."""
    from dpgo_tpu.measurements import RelativeSEMeasurement
    from dpgo_tpu.solvers.averaging import project_to_rotation_group

    def rand_rot():
        return project_to_rotation_group(rng.standard_normal((d, d)))

    # ground-truth trajectory
    Rw = [rand_rot() for _ in range(n)]
    tw = [rng.standard_normal(d) for _ in range(n)]
    meas = []

    def rel(i, j, noise=0.0):
        Rij = Rw[i].T @ Rw[j]
        tij = Rw[i].T @ (tw[j] - tw[i])
        if noise > 0:
            Rij = project_to_rotation_group(
                Rij + noise * rng.standard_normal((d, d))
            )
            tij = tij + noise * rng.standard_normal(d)
        return RelativeSEMeasurement(
            0, 0, i, j, Rij, tij,
            kappa=float(rng.uniform(1.0, 3.0)),
            tau=float(rng.uniform(1.0, 3.0)),
            weight=float(rng.uniform(0.3, 1.0)),
        )

    for i in range(n - 1):
        meas.append(rel(i, i + 1, noise=0.01))
    for _ in range(extra_lc):
        i, j = rng.integers(0, n, 2)
        if abs(int(i) - int(j)) > 1:
            i, j = (int(i), int(j)) if i < j else (int(j), int(i))
            meas.append(rel(i, j, noise=0.01))
    return meas, (Rw, tw)

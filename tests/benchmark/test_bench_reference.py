"""The benchmark's plain reference against the dense f64 oracle, and the
benchmark's world generators against their sizes and the program's."""

import numpy as np
import pytest

from benchmark import reference, worlds
from dpgo_tpu import datasets
from dpgo_tpu.measurements import RelativeSEMeasurement
from tests import oracle


def random_lifted(rng, n, d, r):
    """A random point of the lifted manifold: Stiefel blocks, free
    translations."""
    Y = np.linalg.qr(rng.standard_normal((n, r, d)))[0]
    p = rng.standard_normal((n, r, 1))
    return np.concatenate([Y, p], axis=-1)


def oracle_measurements(world):
    return [RelativeSEMeasurement(0, 0, int(i), int(j), R, t, float(k),
                                  float(tau))
            for i, j, R, t, k, tau in zip(world.p1, world.p2, world.R,
                                          world.t, world.kappa, world.tau)]


@pytest.mark.parametrize("num_poses", [9, 125])
def test_reference_matches_dense_oracle(num_poses):
    world = worlds.synthesize_grid3d(num_poses, seed=1)
    d, r = 3, 5
    X = random_lifted(np.random.default_rng(num_poses), world.n, d, r)
    Q = oracle.dense_connection_laplacian(oracle_measurements(world), world.n)
    Xf = oracle.flat(X)
    G0 = np.zeros_like(Xf)
    # the oracle's f is cost / 2
    dense_cost = 2.0 * oracle.dense_f(Xf, Q, G0)
    egrad = oracle.unflat(oracle.dense_euc_grad(Xf, Q, G0), world.n, d)
    dense_gradnorm = np.linalg.norm(reference.riemannian_gradient(X, egrad, d))

    cost, gradnorm = reference.cost_and_gradnorm(world, X)
    assert cost == pytest.approx(dense_cost, rel=1e-12)
    assert gradnorm == pytest.approx(dense_gradnorm, rel=1e-12)
    _, G = reference.euclidean_gradient(world, X)
    np.testing.assert_allclose(G, egrad, rtol=1e-11, atol=1e-11)


def test_reference_gradient_is_tangent():
    """The projected gradient is tangent: Y^T g is skew in every pose."""
    world = worlds.synthesize_grid3d(27, seed=2)
    X = random_lifted(np.random.default_rng(0), world.n, 3, 5)
    _, G = reference.euclidean_gradient(world, X)
    g = reference.riemannian_gradient(X, G, 3)
    YtG = np.einsum("nra,nrb->nab", X[..., :3], g[..., :3])
    np.testing.assert_allclose(YtG, -np.swapaxes(YtG, -1, -2), atol=1e-10)
    assert reference.stiefel_error(X, 3) < 1e-14


@pytest.mark.parametrize("name, kwargs, edges", [
    ("synthesize_grid3d", {"num_poses": 8000, "lc_fraction": 1.0, "seed": 1},
     22_819),
    ("synthesize_city2d", {"num_poses": 10_000, "seed": 1}, 19_212),
])
def test_worlds_sizes_and_parity_with_program(name, kwargs, edges):
    world = getattr(worlds, name)(**kwargs)
    assert world.m == edges
    prog, n, _ = getattr(datasets, name)(**kwargs)
    assert n == world.n
    for key in ("p1", "p2", "R", "t", "kappa", "tau"):
        np.testing.assert_array_equal(getattr(world, key), getattr(prog, key))

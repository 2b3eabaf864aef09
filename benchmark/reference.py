"""Plain reference: the lifted pose-graph objective in numpy float64.

For a world's edge list and a global lifted iterate X of shape (n, r, d+1)
(pose i is X[i] = [Y_i | p_i], Y_i an r x d Stiefel block, p_i in R^r),

    cost(X) = sum_e kappa_e |Y_j - Y_i R_e|^2 + tau_e |p_j - p_i - Y_i t_e|^2

and the solvers minimise f = cost / 2. The Riemannian gradient of f is the
Euclidean one with sym(Y_i^T G_i) taken out of each rotation block (the
tangent projection of the Stiefel manifold); its Frobenius norm over all
poses is the gradnorm that the stop rules of the cells bound.

Nothing here imports the program: it reads the world the benchmark made
and the iterate the program returned.
"""

from __future__ import annotations

import numpy as np


def homogeneous(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """(m, d, d), (m, d) -> (m, d+1, d+1) blocks [[R, t], [0, 1]]."""
    m, d = t.shape
    T = np.zeros((m, d + 1, d + 1))
    T[:, :d, :d] = R
    T[:, :d, d] = t
    T[:, d, d] = 1.0
    return T


def euclidean_gradient(world, X: np.ndarray):
    """(cost, G): the cost and the Euclidean gradient of f = cost / 2."""
    X = np.asarray(X, np.float64)
    d = world.d
    T = homogeneous(np.asarray(world.R, np.float64),
                    np.asarray(world.t, np.float64))
    om = np.empty((world.m, d + 1))
    om[:, :d] = np.asarray(world.kappa, np.float64)[:, None]
    om[:, d] = np.asarray(world.tau, np.float64)
    Xi = X[world.p1]
    Xj = X[world.p2]
    res = np.einsum("mra,mab->mrb", Xi, T) - Xj  # (m, r, d+1)
    wres = res * om[:, None, :]
    cost = float(np.sum(res * wres))
    G = np.zeros_like(X)
    np.add.at(G, world.p1, np.einsum("mrb,mab->mra", wres, T))
    np.add.at(G, world.p2, -wres)
    return cost, G


def riemannian_gradient(X: np.ndarray, G: np.ndarray, d: int) -> np.ndarray:
    """Project G onto the tangent space at X (rotation blocks only)."""
    Y = X[..., :d]
    Gr = G[..., :d]
    YtG = np.einsum("nra,nrb->nab", Y, Gr)
    sym = 0.5 * (YtG + np.swapaxes(YtG, -1, -2))
    out = np.array(G, copy=True)
    out[..., :d] = Gr - np.einsum("nra,nab->nrb", Y, sym)
    return out


def cost_and_gradnorm(world, X: np.ndarray):
    """(cost, Riemannian gradnorm of cost / 2) at the global iterate X."""
    X = np.asarray(X, np.float64)
    cost, G = euclidean_gradient(world, X)
    rg = riemannian_gradient(X, G, world.d)
    return cost, float(np.sqrt(np.sum(rg * rg)))


def stiefel_error(X: np.ndarray, d: int) -> float:
    """max_i |Y_i^T Y_i - I|: how far the rotation blocks are off the manifold."""
    Y = np.asarray(X, np.float64)[..., :d]
    YtY = np.einsum("nra,nrb->nab", Y, Y)
    return float(np.max(np.abs(YtY - np.eye(d))))

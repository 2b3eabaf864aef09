"""Seeded pose-graph worlds, kept with the benchmark.

Copies of the program's `synthesize_grid3d` and `synthesize_city2d`, so that
a change to the program's generators cannot move the yardstick. Both return
a `World`: plain numpy edge arrays and nothing of the program.

A configuration fixes the generator's `seed`: like a published data set,
its world is one graph, the same in every run. What a run's `--seed` draws
(the order the edges arrive in and the lifting matrix) is in `run.py`.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class World:
    """A pose graph: edge k measures pose p2[k] relative to pose p1[k]."""

    d: int
    n: int
    p1: np.ndarray  # (m,) int32
    p2: np.ndarray  # (m,) int32
    R: np.ndarray  # (m, d, d)
    t: np.ndarray  # (m, d)
    kappa: np.ndarray  # (m,) rotation precision
    tau: np.ndarray  # (m,) translation precision

    @property
    def m(self) -> int:
        return int(self.p1.shape[0])


def _random_rotations(rng: np.random.Generator, m: int, scale: float) -> np.ndarray:
    """Batched small random rotations: SVD projection of I + scale * noise."""
    A = scale * rng.standard_normal((m, 3, 3))
    M = np.tile(np.eye(3), (m, 1, 1)) + A
    U, _, Vt = np.linalg.svd(M)
    det = np.linalg.det(U @ Vt)
    U[:, :, -1] *= np.sign(det)[:, None]
    return U @ Vt


def synthesize_grid3d(
    num_poses: int,
    kappa: float = 100.0,
    tau: float = 10.0,
    rot_noise: float = 0.02,
    tran_noise: float = 0.02,
    lc_fraction: float = 0.8,
    seed: int = 0,
) -> World:
    """SE(3) grid world: a snake path through every cell of an s^3 grid
    (odometry chain) plus loop closures between lattice neighbours that are
    not neighbours along the path."""
    rng = np.random.default_rng(seed)
    s = int(round(num_poses ** (1.0 / 3.0)))
    while s**3 < num_poses:
        s += 1
    coords = []
    for zi in range(s):
        for yi in range(s):
            xs = np.arange(s) if (zi * s + yi) % 2 == 0 else np.arange(s)[::-1]
            for xi in xs:
                coords.append((xi, yi, zi))
    coords = np.array(coords[:num_poses], dtype=np.float64)
    n = num_poses

    R_true = _random_rotations(rng, n, 1.0)
    t_true = coords

    cell_index = -np.ones((s, s, s), dtype=np.int64)
    ci = coords.astype(np.int64)
    cell_index[ci[:, 0], ci[:, 1], ci[:, 2]] = np.arange(n)

    io = np.arange(n - 1)
    jo = io + 1

    lc_pairs = []
    for axis in range(3):
        nb = ci.copy()
        nb[:, axis] += 1
        valid = nb[:, axis] < s
        src = np.arange(n)[valid]
        dst = cell_index[nb[valid, 0], nb[valid, 1], nb[valid, 2]]
        ok = (dst >= 0) & (np.abs(dst - src) > 1)
        a = np.minimum(src[ok], dst[ok])
        b = np.maximum(src[ok], dst[ok])
        lc_pairs.append(np.stack([a, b], axis=1))
    lc = np.unique(np.concatenate(lc_pairs, axis=0), axis=0)
    keep = rng.random(len(lc)) < lc_fraction
    lc = lc[keep]

    i_all = np.concatenate([io, lc[:, 0]])
    j_all = np.concatenate([jo, lc[:, 1]])
    m = len(i_all)

    Ri = R_true[i_all]
    Rj = R_true[j_all]
    R_rel = np.einsum("mba,mbc->mac", Ri, Rj)  # Ri^T Rj
    noise_R = _random_rotations(rng, m, rot_noise)
    R_meas = np.einsum("mab,mbc->mac", R_rel, noise_R)
    t_rel = np.einsum("mba,mb->ma", Ri, t_true[j_all] - t_true[i_all])
    t_meas = t_rel + tran_noise * rng.standard_normal((m, 3))
    return World(
        d=3, n=n, p1=i_all.astype(np.int32), p2=j_all.astype(np.int32),
        R=R_meas, t=t_meas, kappa=np.full(m, kappa), tau=np.full(m, tau),
    )


def synthesize_city2d(
    num_poses: int,
    kappa: float = 50.0,
    tau: float = 5.0,
    rot_noise: float = 0.01,
    tran_noise: float = 0.05,
    lc_per_pose: float = 1.05,
    min_gap: int = 10,
    p_turn: float = 0.2,
    seed: int = 0,
) -> World:
    """SE(2) Manhattan world: a vehicle random-walking a bounded street grid,
    odometry chain plus loop closures between far-apart revisits of one cell
    (the shape of the city10000 family: closures at revisit-time offsets)."""
    rng = np.random.default_rng(seed)
    n = num_poses
    s = max(8, int(round(np.sqrt(n) / 4.0)))

    turns = rng.random(n)
    turn_dir = rng.integers(0, 2, n) * 2 - 1  # -1 or +1
    DX = np.array([1, 0, -1, 0])
    DY = np.array([0, 1, 0, -1])
    pos = np.empty((n, 2), np.int64)
    head = np.empty(n, np.int64)
    x = y = s // 2
    h = 0
    for k in range(n):
        pos[k] = (x, y)
        head[k] = h
        if turns[k] < p_turn:
            h = (h + turn_dir[k]) % 4
        for _ in range(4):
            nx, ny = x + DX[h], y + DY[h]
            if 0 <= nx < s and 0 <= ny < s:
                break
            h = (h + 1) % 4
        x, y = x + DX[h], y + DY[h]

    theta = head * (np.pi / 2.0)
    c, si = np.cos(theta), np.sin(theta)
    R_true = np.stack(
        [np.stack([c, -si], axis=-1), np.stack([si, c], axis=-1)], axis=-2
    )
    t_true = pos.astype(np.float64)

    cell = pos[:, 0] * s + pos[:, 1]
    order = np.argsort(cell, kind="stable")
    cs = cell[order]
    same = cs[1:] == cs[:-1]
    a = order[:-1][same]
    b = order[1:][same]
    lo = np.minimum(a, b)
    hi = np.maximum(a, b)
    ok = hi - lo >= min_gap
    lo, hi = lo[ok], hi[ok]
    target = int(lc_per_pose * n)
    if len(lo) > target:
        pick = rng.choice(len(lo), target, replace=False)
        pick.sort()
        lo, hi = lo[pick], hi[pick]

    i_all = np.concatenate([np.arange(n - 1), lo])
    j_all = np.concatenate([np.arange(1, n), hi])
    m = len(i_all)

    Ri = R_true[i_all]
    Rj = R_true[j_all]
    R_rel = np.einsum("mba,mbc->mac", Ri, Rj)  # Ri^T Rj
    ang = rot_noise * rng.standard_normal(m)
    ca, sa = np.cos(ang), np.sin(ang)
    noise_R = np.stack(
        [np.stack([ca, -sa], axis=-1), np.stack([sa, ca], axis=-1)], axis=-2
    )
    R_meas = np.einsum("mab,mbc->mac", R_rel, noise_R)
    t_rel = np.einsum("mba,mb->ma", Ri, t_true[j_all] - t_true[i_all])
    t_meas = t_rel + tran_noise * rng.standard_normal((m, 2))
    return World(
        d=2, n=n, p1=i_all.astype(np.int32), p2=j_all.astype(np.int32),
        R=R_meas, t=t_meas, kappa=np.full(m, kappa), tau=np.full(m, tau),
    )

"""SPMD mesh-parallel RBCD: agents as positions along a device mesh axis.

This is the flagship accelerator path. Where the reference moves PoseDicts by
message passing (ROS / direct calls; see SURVEY.md §2.4), here the whole team
is one SPMD program over a `jax.sharding.Mesh` with an "agents" axis:

  * every agent's block of the lifted variable X lives in one stacked array
    (N, n_max, r, d+1), sharded along the agent axis;
  * public-pose exchange is ONE `lax.all_gather` of the (small) public-pose
    buffers over the agent axis — the device interconnect replaces the
    network;
  * each device runs the batched local RTR solve for its agents (vmap over
    agents-per-device, every per-pose op batched);
  * status exchange (block gradient norms for greedy selection, termination
    metrics, global cost) is a `psum`/`all_gather` of scalars.

Update modes:
  * 'all'     — every agent optimizes its block every round (Jacobi-style
                parallel block-coordinate descent; the bulk-synchronous form
                of the RA-L 2020 asynchronous update model). Uses all devices
                every round; the default for throughput.
  * 'greedy'  — only the agent with the max block gradient norm optimizes
                (the reference example's rule, MultiRobotExample.cpp:233-247);
                sequential-RBCD parity.
  * 'uniform' — one uniformly-random agent optimizes (RBCD paper's sampling).

Nesterov acceleration follows PGOAgent.cpp:899-936: globally synchronized
gamma/alpha recursions, Y/V auxiliary iterates with SVD projection, periodic
restart every `restart_interval` rounds.

All shapes are static (agents padded to n_max poses / mp_max private edges /
ms_max shared edges / p_max public poses); per-round data changes are array
values only, so the whole optimization — including the nested RTR/tCG
while_loops — is one compiled XLA program per problem shape.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dpgo_tpu import quadratic
from dpgo_tpu.measurements import RelativeSEMeasurement, homogeneous
from dpgo_tpu.ops import lifted
from dpgo_tpu.parallel.partition import partition_measurements
from dpgo_tpu.solvers import rtr as rtr_mod


# ---------------------------------------------------------------------------
# Problem container
# ---------------------------------------------------------------------------

_DATA_FIELDS = [
    "priv_i", "priv_j", "priv_T", "priv_kappa", "priv_tau", "priv_weight",
    "priv_fixed_weight", "priv_lane",
    "shared_idx", "shared_T", "shared_kappa", "shared_tau", "shared_weight",
    "shared_outgoing", "shared_nbr_robot", "shared_nbr_slot",
    "shared_fixed_weight",
    "pub_idx", "pub_mask", "pose_mask",
    "robot_active",
]

# robot_active is (N,) — the whole team's membership vector, replicated on
# every device (each device needs its NEIGHBORS' activity, not just its own
# agents'); everything else is sharded along the agent axis.
_REPLICATED_FIELDS = {"robot_active"}

_META_FIELDS = ["num_agents", "n_max", "d", "r", "num_band", "band_offsets"]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=_DATA_FIELDS,
    meta_fields=_META_FIELDS,
)
@dataclasses.dataclass(frozen=True)
class SPMDProblem:
    """Stacked per-agent local problems, leading axis = agent.

    Padding: edges beyond an agent's real count carry weight 0 and index 0;
    poses beyond n_i are masked by pose_mask. Neighbor addressing per shared
    edge is (robot, slot-in-that-robot's-public-buffer), resolved against the
    all-gathered public-pose tensor.
    """

    num_agents: int
    n_max: int
    d: int
    r: int
    num_band: int
    band_offsets: tuple
    # private edges (N, mp) / (N, mp, dh, dh)
    priv_i: jax.Array
    priv_j: jax.Array
    priv_T: jax.Array
    priv_kappa: jax.Array
    priv_tau: jax.Array
    priv_weight: jax.Array
    priv_fixed_weight: jax.Array  # bool (GNC: odometry weights stay fixed)
    priv_lane: jax.Array  # (N, mp) int32 band-lane id for the banded prefix
    # shared edges (N, ms) / (N, ms, dh, dh)
    shared_idx: jax.Array
    shared_T: jax.Array
    shared_kappa: jax.Array
    shared_tau: jax.Array
    shared_weight: jax.Array
    shared_outgoing: jax.Array  # bool
    shared_nbr_robot: jax.Array
    shared_nbr_slot: jax.Array
    shared_fixed_weight: jax.Array  # bool (GNC)
    # public-pose bookkeeping
    pub_idx: jax.Array  # (N, p_max) local frame ids
    pub_mask: jax.Array  # (N, p_max)
    pose_mask: jax.Array  # (N, n_max)
    # elastic membership: (N,) bool, REPLICATED (not sharded) — reference:
    # setRobotActive (PGOAgent.cpp:1173-1184). Inactive robots are frozen,
    # their shared edges drop out of every Q/G/cost/gradient (PoseGraph.cpp:
    # 418-430, 520-532), and they are skipped in selection, termination
    # metrics, and GNC weight updates (PGOAgent.cpp:860-861, 1015-1016).
    robot_active: jax.Array

    @property
    def dh(self) -> int:
        return self.d + 1

    def with_robot_active(self, active) -> "SPMDProblem":
        """Runtime membership change (pure array data: no recompilation)."""
        return dataclasses.replace(
            self, robot_active=jnp.asarray(active, bool)
        )


class SPMDState(NamedTuple):
    X: jax.Array  # (N, n_max, r, dh)
    Y: jax.Array  # Nesterov aux (== X when acceleration off)
    V: jax.Array
    gamma: jax.Array  # scalar
    it: jax.Array  # int32 round counter
    cost_X: jax.Array  # global objective at the current X (inf until evaluated)
    do_restart: jax.Array  # bool: adaptive-restart request for the next round


class RoundMetrics(NamedTuple):
    cost: jax.Array  # global objective sum_e cost_e
    gradnorm: jax.Array  # global Riemannian gradient norm
    max_rel_change: jax.Array  # max over agents of maxTranslationDistance


@dataclasses.dataclass(frozen=True)
class SPMDConfig:
    mode: str = "all"  # 'all' | 'greedy' | 'uniform' | 'async'
    acceleration: bool = True
    # mode='async': semantic-async RBCD — each agent's Poisson clock fires
    # within a round with probability 1 - exp(-async_rate) and only firing
    # agents update (Poisson thinning of the RA-L 2020 asynchronous update
    # model; SURVEY §7 hard part 4). This is the device-resident counterpart of
    # the reference's per-agent host threads with Exp(rate) sleeps
    # (PGOAgent.cpp:486-499): the round plays the role of a unit time slice,
    # and updates within a round use round-start neighbor poses (bounded
    # staleness, exactly the partially-asynchronous model the RA-L analysis
    # covers). Acceleration is forbidden, as in the reference (:477).
    async_rate: float = 0.7
    restart_interval: int = 30
    # Adaptive (function-scheme) restart on top of the periodic schedule:
    # restart whenever the global objective at X increased over the last round
    # (O'Donoghue & Candes adaptive-restart rule). Costs one extra public-pose
    # all_gather + edge-cost evaluation per round; off by default for exact
    # reference parity (the reference restarts only periodically,
    # PGOAgent.cpp:880-885).
    adaptive_restart: bool = False
    # Noise margin for the adaptive trigger: restart only when
    # cost_new > cost_prev * (1 + rtol). Default 0 = the exact O'Donoghue &
    # Candes comparison. Experimental knob: a 64*eps(f32) margin was tried
    # to stop tail restarts firing on f32 cost noise, but the hair trigger
    # is load-bearing — with the margin the Jacobi-parallel schedule
    # oscillates instead of converging (grid3d-10k: cost bouncing
    # 1957.15<->1957.21 for 3000 rounds, certified=NO, vs 261 rounds
    # certified with the raw trigger). Leave at 0.
    restart_cost_rtol: float = 0.0
    # Which O'Donoghue & Candes adaptive-restart signal to use (delta
    # engine only; the plain engine always uses 'cost'):
    # 'cost'     — restart when the round objective increased (function
    #              scheme, compared in accumulated f32 — fires on rounding
    #              noise once true per-round decreases drop below
    #              eps*|f|, which kills tail momentum at 100k scale);
    # 'exact'    — the SAME function-scheme comparison computed
    #              cancellation-free in delta space via the quadratic
    #              identity f(x')-f(x) = <2 eg(Y) + Q W, x'-x>,
    #              W=(x-Y)+(x'-Y) (one extra residual-form matvec per
    #              round; resolution eps*|g|*|step|);
    # 'gradient' — <grad f(Y), x'-x> > 0 (no matvec; measured to
    #              under-restart on small worlds, experimental).
    restart_scheme: str = "cost"
    # Team size N in the Nesterov gamma/alpha recursions. The reference always
    # uses the robot count (PGOAgent.cpp:910-920) — the right schedule when
    # one block updates per round. None = num_agents.
    nesterov_n: Optional[int] = None
    gradnorm_tol: float = 1e-2
    # local RTR budget per round (reference: DPGO_types.h:59-61 defaults)
    rtr_iterations: int = 1
    rtr_tcg_iterations: int = 50
    rtr_initial_radius: float = 100.0
    rtr_gradnorm_tol: float = 1e-2
    # run the tCG inner loops in reduced precision ('float32') while keeping
    # trust-region control in the state dtype — see solvers/rtr.py. None
    # keeps a single precision level.
    rtr_inner_dtype: Optional[str] = None
    # dtype of the Newton-Schulz Nesterov projections in mixed mode; None =
    # mixed f32 bulk + full-precision polish (recommended — see _round_body)
    ns_projection_dtype: Optional[str] = None
    # in mixed mode, recompute H(eta) in full precision for the trust-region
    # model decrease (see solvers/rtr.py). The inner-precision H(eta) is
    # accurate to f32 RELATIVE error — sufficient for the rho thresholds —
    # so the default skips one full-precision matvec per round.
    rtr_exact_inner_hessian: bool = False
    # in mixed mode, run the trust-region control matvecs (initial cost/
    # gradient, post-step cost/gradient) in inner precision (HIGHEST, i.e.
    # true f32) too, with the actual decrease computed via the
    # cancellation-free difference identity (see solvers/rtr.py). Removes
    # ALL full-precision matvecs from the round (~1.7x per-round at 10k+
    # poses), but the f32-computed gradient floors the reachable global
    # gradnorm around ~2e-2 — use for the bulk of the run and hand off to a
    # rtr_inner_control_matvecs=False program for the final stretch
    # (make_two_phase_run_fn does exactly this).
    rtr_inner_control_matvecs: bool = False
    # tCG matmul precision for f32 states: None (the backend's default — a
    # GPU may use TF32, ~3 decimal digits; fine when an f64 or mixed control
    # loop cleans up steps), 'high', or 'highest' (true f32). The pure-f32
    # certified path needs at least 'high' — see solvers/rtr.py. f64 states
    # are unaffected.
    rtr_tcg_precision: Optional[str] = None
    # Residual-form trust-region control (quadratic.cost_grad_residual): the
    # control gradient/cost are evaluated cancellation-free per edge, so the
    # control dtype's eps applies to the RESIDUAL rather than to O(kappa·|X|)
    # near-cancelling partial sums. With an f32 state this certifies
    # f64-class gradient norms with zero f64 tensor kernels — the 100k-scale
    # path. Implies inner-control-matvec semantics for the cost decrease.
    rtr_residual_control: bool = False
    # preconditioner for the local solves: 'auto' (per-agent EXACT banded
    # factor when the stacked RCM plan fits — reference parity: each agent
    # owns a Cholmod LDL^T of its local Q, PoseGraph.cpp:598-613 — else
    # tridiag when the odometry lane exists and the block is small enough
    # that the cyclic-reduction solve pays off, else block-Jacobi),
    # 'banded', 'jacobi', or 'tridiag'. The banded plan needs concrete edge
    # indices, so make_run_fn/make_step_fn build it host-side at
    # construction time; inside other jit contexts 'auto'/'banded' degrade
    # as documented in quadratic.build_q_data.
    precond: str = "auto"
    # elastic membership: keep using the last known (frozen) pose of an
    # inactive neighbor instead of dropping its shared edges (reference:
    # `useInactiveNeighbors`, PoseGraph.cpp:632-635)
    use_inactive_neighbors: bool = False
    seed: int = 0


# ---------------------------------------------------------------------------
# Host-side builder
# ---------------------------------------------------------------------------

def build_spmd_problem(
    measurements: Sequence[RelativeSEMeasurement],
    num_poses: int,
    num_agents: int,
    r: int,
    dtype=jnp.float64,
) -> Tuple[SPMDProblem, List[Tuple[int, int]]]:
    """Partition a global dataset and pack it into stacked padded arrays.
    Returns (problem, global index ranges per agent)."""
    d = measurements[0].d
    dh = d + 1
    odometry, private_lcs, shared_lcs, ranges = partition_measurements(
        measurements, num_poses, num_agents
    )

    n_max = max(end - start for start, end in ranges)
    # Private-edge layout per agent: banded edges first (each assigned a
    # lane — offset delta = p2 - p1 drawn from a small team-wide offset set,
    # odometry being offset 1; backward edges keep their NEGATIVE offset and
    # get their own lane — the lifted translation cost is not invariant under
    # edge reversal, so edges are never flipped), then the remaining loop
    # closures. Banded edges' matvec contributions lower to shifted dense
    # batched matmuls in q_matvec (zero gather/scatter). The offset set is
    # static metadata under vmap, so it must be uniform across agents: chosen
    # from the pooled offset histogram.
    priv_lists = [
        odometry[a] + private_lcs[a] for a in range(num_agents)
    ]
    all_i = np.array([m.p1 for pl in priv_lists for m in pl], np.int64)
    all_j = np.array([m.p2 for pl in priv_lists for m in pl], np.int64)
    # rows: the vmapped lane einsum spans every agent's n_max rows, and the
    # offset histogram is pooled across agents — the lane cost model must
    # compare pooled counts against the full stacked row count
    band_offsets = quadratic.choose_band_offsets(
        all_i, all_j, n_max, rows=num_agents * n_max
    )
    lane_of = {delta: k for k, delta in enumerate(band_offsets)}

    def split_banded(pl):
        banded = [m for m in pl if (m.p2 - m.p1) in lane_of]
        rest = [m for m in pl if (m.p2 - m.p1) not in lane_of]
        return banded, rest

    split = [split_banded(pl) for pl in priv_lists]
    num_band = max((len(b) for b, _ in split), default=0)
    mp_max = num_band + max(1, max((len(rst) for _, rst in split), default=1))
    ms_max = max(1, max(len(s) for s in shared_lcs))

    # public-pose slots: for each agent, sorted local frame ids that appear in
    # any shared edge (the agent's public poses)
    pub_sets: List[List[int]] = []
    for a in range(num_agents):
        s = set()
        for m in shared_lcs[a]:
            if m.r1 == a:
                s.add(m.p1)
            else:
                s.add(m.p2)
        pub_sets.append(sorted(s))
    p_max = max(1, max(len(s) for s in pub_sets))
    slot_of = [
        {fid: k for k, fid in enumerate(pub_sets[a])} for a in range(num_agents)
    ]

    def pad(x, shape, dt=np.float64):
        out = np.zeros(shape, dt)
        if len(x):
            arr = np.asarray(x, dt)
            out[tuple(slice(0, s) for s in arr.shape)] = arr
        return out

    P_i = np.zeros((num_agents, mp_max), np.int32)
    P_j = np.zeros((num_agents, mp_max), np.int32)
    P_T = np.zeros((num_agents, mp_max, dh, dh))
    P_k = np.zeros((num_agents, mp_max))
    P_t = np.zeros((num_agents, mp_max))
    P_w = np.zeros((num_agents, mp_max))
    P_fx = np.zeros((num_agents, mp_max), bool)
    P_ln = np.zeros((num_agents, mp_max), np.int32)
    S_idx = np.zeros((num_agents, ms_max), np.int32)
    S_T = np.zeros((num_agents, ms_max, dh, dh))
    S_k = np.zeros((num_agents, ms_max))
    S_t = np.zeros((num_agents, ms_max))
    S_w = np.zeros((num_agents, ms_max))
    S_out = np.zeros((num_agents, ms_max), bool)
    S_nr = np.zeros((num_agents, ms_max), np.int32)
    S_ns = np.zeros((num_agents, ms_max), np.int32)
    S_fx = np.zeros((num_agents, ms_max), bool)
    PUB = np.zeros((num_agents, p_max), np.int32)
    PUBM = np.zeros((num_agents, p_max))
    POSM = np.zeros((num_agents, n_max))

    for a in range(num_agents):
        n_a = ranges[a][1] - ranges[a][0]
        POSM[a, :n_a] = 1.0
        # banded edges first (zero-weight padding up to num_band is inert:
        # its E blocks are 0), then the leftover loop closures
        banded_a, rest_a = split[a]
        for k, m in enumerate(banded_a + [None] * (num_band - len(banded_a))
                              + rest_a):
            if m is None:
                continue
            P_i[a, k] = m.p1
            P_j[a, k] = m.p2
            P_T[a, k] = homogeneous(m.R, m.t)
            P_k[a, k] = m.kappa
            P_t[a, k] = m.tau
            P_w[a, k] = m.weight
            P_fx[a, k] = m.fixed_weight
            if k < num_band:
                P_ln[a, k] = lane_of[m.p2 - m.p1]
        for k, m in enumerate(shared_lcs[a]):
            S_T[a, k] = homogeneous(m.R, m.t)
            S_k[a, k] = m.kappa
            S_t[a, k] = m.tau
            S_w[a, k] = m.weight
            S_fx[a, k] = m.fixed_weight
            if m.r1 == a:
                S_idx[a, k] = m.p1
                S_out[a, k] = True
                S_nr[a, k] = m.r2
                S_ns[a, k] = slot_of[m.r2][m.p2]
            else:
                S_idx[a, k] = m.p2
                S_out[a, k] = False
                S_nr[a, k] = m.r1
                S_ns[a, k] = slot_of[m.r1][m.p1]
        for k, fid in enumerate(pub_sets[a]):
            PUB[a, k] = fid
            PUBM[a, k] = 1.0

    problem = SPMDProblem(
        num_agents=num_agents, n_max=n_max, d=d, r=r, num_band=num_band,
        band_offsets=band_offsets,
        priv_i=jnp.asarray(P_i), priv_j=jnp.asarray(P_j),
        priv_T=jnp.asarray(P_T, dtype),
        priv_kappa=jnp.asarray(P_k, dtype), priv_tau=jnp.asarray(P_t, dtype),
        priv_weight=jnp.asarray(P_w, dtype),
        priv_fixed_weight=jnp.asarray(P_fx),
        priv_lane=jnp.asarray(P_ln),
        shared_idx=jnp.asarray(S_idx), shared_T=jnp.asarray(S_T, dtype),
        shared_kappa=jnp.asarray(S_k, dtype), shared_tau=jnp.asarray(S_t, dtype),
        shared_weight=jnp.asarray(S_w, dtype),
        shared_outgoing=jnp.asarray(S_out),
        shared_nbr_robot=jnp.asarray(S_nr), shared_nbr_slot=jnp.asarray(S_ns),
        shared_fixed_weight=jnp.asarray(S_fx),
        pub_idx=jnp.asarray(PUB), pub_mask=jnp.asarray(PUBM, dtype),
        pose_mask=jnp.asarray(POSM, dtype),
        robot_active=jnp.ones((num_agents,), bool),
    )
    return problem, ranges


def initial_state(
    problem: SPMDProblem,
    X0: Optional[np.ndarray] = None,
    ranges: Optional[List[Tuple[int, int]]] = None,
) -> SPMDState:
    """Initial SPMD state from a global (n, r, dh) iterate (e.g. lifted
    chordal initialization) or padded identity."""
    N, n_max, r, dh = problem.num_agents, problem.n_max, problem.r, problem.dh
    dtype = problem.priv_T.dtype
    X = np.tile(
        np.asarray(lifted.identity_lifted(n_max, r, problem.d, dtype=dtype)),
        (N, 1, 1, 1),
    )
    if X0 is not None:
        assert ranges is not None
        X0 = np.asarray(X0)
        for a, (s, e) in enumerate(ranges):
            X[a, : e - s] = X0[s:e]
    Xj = jnp.asarray(X, dtype)
    return SPMDState(
        X=Xj, Y=Xj, V=Xj,
        gamma=jnp.asarray(0.0, Xj.dtype),
        it=jnp.asarray(0, jnp.int32),
        cost_X=jnp.asarray(jnp.inf, Xj.dtype),
        do_restart=jnp.asarray(False),
    )


# ---------------------------------------------------------------------------
# Per-agent pieces (vmapped over the agents-per-device axis)
# ---------------------------------------------------------------------------

def _agent_local_problem(problem: SPMDProblem, a_priv, a_shared) -> quadratic.LocalProblem:
    """Assemble a LocalProblem for ONE agent from sliced arrays."""
    (pi, pj, pT, pk, pt, pw, pl) = a_priv
    (sidx, sT, sk, st, sw, sout, smask) = a_shared
    r = problem.r
    # The caller resolves neighbor poses per edge, so the LocalProblem's
    # neighbor buffer is indexed by edge position (identity slots).
    ms = sidx.shape[0]
    return quadratic.LocalProblem(
        n=problem.n_max, d=problem.d, num_band=problem.num_band,
        band_offsets=problem.band_offsets, priv_lane=pl,
        priv_i=pi, priv_j=pj, priv_T=pT,
        priv_kappa=pk, priv_tau=pt, priv_weight=pw,
        shared_idx=sidx, shared_T=sT,
        shared_kappa=sk, shared_tau=st, shared_weight=sw,
        shared_outgoing=sout,
        shared_nbr_slot=jnp.arange(ms, dtype=jnp.int32),
        shared_mask=smask,
        prior_idx=jnp.zeros((0,), jnp.int32),
        prior_pose=jnp.zeros((0, r, problem.dh), sT.dtype),
        prior_mask=jnp.zeros((0,), sT.dtype),
    )


def _shared_activity_mask(problem_blk: SPMDProblem, cfg: "SPMDConfig"):
    """(A, ms) float mask dropping shared edges whose NEIGHBOR robot is
    inactive (reference: PoseGraph.cpp:418-430, 520-532). With
    cfg.use_inactive_neighbors the last known (frozen) pose of an inactive
    neighbor keeps being used instead (PoseGraph.cpp:632-635,
    `useInactiveNeighbors`) — under SPMD the frozen pose is still present in
    the all-gathered public buffer, so the edges simply stay on."""
    dtype = problem_blk.shared_T.dtype
    if cfg.use_inactive_neighbors:
        return jnp.ones(problem_blk.shared_idx.shape, dtype)
    return problem_blk.robot_active[problem_blk.shared_nbr_robot].astype(dtype)


def _edge_cost_terms(X, nbr, lp: quadratic.LocalProblem, outgoing_only: jax.Array):
    """Sum of lifted edge costs for one agent:
    private edges fully + shared edges attributed to the outgoing side, so the
    team-wide psum equals the global objective <X Q_global, X>.

    HIGHEST matmul precision throughout: this value feeds DECISIONS (the
    adaptive-restart comparison cost_new > cost_prev and the reported
    objective). A reduced-precision f32 product (TF32 on a GPU keeps ~3
    decimal digits) at a cost scale of ~1e3 turns the restart comparison
    into noise, firing restarts at random and destroying the Nesterov
    momentum. Two small einsums per edge per round — negligible next to the
    tCG loop."""
    d = lp.d
    hi = jax.lax.Precision.HIGHEST
    # private
    Yi = X[lp.priv_i]
    Yj = X[lp.priv_j]
    Ri = jnp.einsum("mra,mab->mrb", Yi[..., :d], lp.priv_T[..., :d, :d],
                    precision=hi)
    rot = jnp.sum((Ri - Yj[..., :d]) ** 2, axis=(-2, -1))
    ti = jnp.einsum("mra,mab->mrb", Yi[..., :d], lp.priv_T[..., :d, d:],
                    precision=hi) + Yi[..., d:]
    tr = jnp.sum((ti - Yj[..., d:]) ** 2, axis=(-2, -1))
    c_priv = jnp.sum(lp.priv_weight * (lp.priv_kappa * rot + lp.priv_tau * tr))
    # shared (only outgoing edges; tail = me, head = neighbor)
    Xi = X[lp.shared_idx]
    Ri = jnp.einsum("mra,mab->mrb", Xi[..., :d], lp.shared_T[..., :d, :d],
                    precision=hi)
    rot = jnp.sum((Ri - nbr[..., :d]) ** 2, axis=(-2, -1))
    ti = jnp.einsum("mra,mab->mrb", Xi[..., :d], lp.shared_T[..., :d, d:],
                    precision=hi) + Xi[..., d:]
    tr = jnp.sum((ti - nbr[..., d:]) ** 2, axis=(-2, -1))
    w = lp.shared_weight * lp.shared_mask * outgoing_only
    c_shared = jnp.sum(w * (lp.shared_kappa * rot + lp.shared_tau * tr))
    return c_priv + c_shared


def _build_qd_static(problem: SPMDProblem, cfg: SPMDConfig):
    """Stacked per-agent round-invariant data: Q blocks + preconditioner
    factors (vmapped build_q_data). Computed once per run — only the linear
    term G depends on the per-round neighbor poses (the same caching the
    reference does with std::optional data matrices, PoseGraph.h:325-331)."""
    pr = problem
    a_priv = (pr.priv_i, pr.priv_j, pr.priv_T, pr.priv_kappa, pr.priv_tau,
              pr.priv_weight, pr.priv_lane)
    a_shared = (pr.shared_idx, pr.shared_T, pr.shared_kappa, pr.shared_tau,
                pr.shared_weight, pr.shared_outgoing,
                _shared_activity_mask(pr, cfg))

    def one(priv, shared):
        lp = _agent_local_problem(pr, priv, shared)
        return quadratic.build_q_data(lp, r=pr.r, precond=cfg.precond)

    return jax.vmap(one)(a_priv, a_shared)


# factor-memory cap for the auto-selected stacked banded preconditioner:
# ~5 * nb * (s*dh)^2 floats per agent across the cyclic-reduction levels
_BANDED_AUTO_BYTES = 2 << 30


def _plan_banded_static(problem: SPMDProblem, cfg: SPMDConfig):
    """Host-side (construction-time): the stacked per-agent RCM banded plan,
    or None when unavailable/not selected. Returns (splan, arrays) where
    arrays is the flat tuple of per-agent plan index arrays that the jitted
    driver threads through as runtime inputs (sharded along 'agents' on a
    mesh)."""
    if cfg.precond not in ("auto", "banded"):
        return None, ()
    import jax.core as _core

    if isinstance(problem.priv_i, _core.Tracer):
        return None, ()
    from dpgo_tpu.ops import block_tridiag as _bt

    splan = _bt.make_banded_plans_stacked(
        np.asarray(problem.priv_i), np.asarray(problem.priv_j),
        problem.n_max, problem.d + 1,
    )
    if splan is None:
        return None, ()
    sdh = splan.s * splan.dh
    A = problem.priv_i.shape[0]
    if cfg.precond == "auto" and \
            A * 5 * splan.nb * sdh * sdh * 4 > _BANDED_AUTO_BYTES:
        return None, ()
    arrays = tuple(
        jnp.asarray(getattr(splan, f)) for f in _bt._STACKED_ARRAY_FIELDS
    )
    return splan, arrays


def _attach_banded_static(pr_blk, qd_static, splan, b_arrays):
    """Inside jit: build the stacked per-agent exact banded factor from the
    runtime weights (GNC reweights take effect without recompiling — the
    scatter indices in b_arrays are static data) and attach it to the
    per-agent QuadraticData (apply_precond dispatches on btf)."""
    from dpgo_tpu.ops import block_tridiag as _bt

    d = pr_blk.d
    dh = d + 1

    def one(arrays, kappa, tau, w, T, diag):
        plan = _bt.BandedPlan(
            s=splan.s, nb=splan.nb, n=splan.n, dh=splan.dh, bandwidth=0,
            pad_diag=splan.pad_diag, dropped=0,
            **dict(zip(_bt._STACKED_ARRAY_FIELDS, arrays)),
        )
        om = quadratic._omega(kappa, tau, w, d)
        E = T * om[:, None, :]
        shifted = diag + quadratic.PRECONDITIONER_SHIFT * jnp.eye(
            dh, dtype=diag.dtype
        )
        return _bt.build_banded_factor(plan, shifted, E)

    bf = jax.vmap(one)(
        b_arrays, pr_blk.priv_kappa, pr_blk.priv_tau, pr_blk.priv_weight,
        pr_blk.priv_T, qd_static.diag,
    )
    return dataclasses.replace(qd_static, btf=bf)


def _agent_round(
    problem: SPMDProblem,
    cfg: SPMDConfig,
    qd_static,  # round-invariant QuadraticData for this agent (G unused)
    X0: jax.Array,  # (n_max, r, dh) starting point for the local solve
    a_priv, a_shared,
    nbr_poses: jax.Array,  # (ms, r, dh)
    do_opt: jax.Array,  # scalar bool: does this agent optimize this round?
):
    """One agent's local round: rebuild G from the exchanged neighbor poses,
    masked RTR solve. Returns (X_new, local riegradnorm at X0, cost
    contribution at X0)."""
    lp = _agent_local_problem(problem, a_priv, a_shared)
    G = quadratic.build_linear_term(lp, nbr_poses, r=problem.r)
    res = (
        quadratic.build_residual_data(lp, nbr_poses)
        if cfg.rtr_residual_control else None
    )
    qd = dataclasses.replace(qd_static, G=G, res=res)

    Xopt, stats = rtr_mod.rtr_solve(
        qd, X0,
        gradnorm_tol=cfg.rtr_gradnorm_tol,
        initial_radius=cfg.rtr_initial_radius,
        max_iterations=cfg.rtr_iterations,
        max_inner=cfg.rtr_tcg_iterations,
        shrink_until_accept=(cfg.rtr_iterations == 1),
        inner_dtype=jnp.dtype(cfg.rtr_inner_dtype) if cfg.rtr_inner_dtype else None,
        exact_inner_hessian=cfg.rtr_exact_inner_hessian,
        inner_control_matvecs=cfg.rtr_inner_control_matvecs,
        residual_control=cfg.rtr_residual_control,
        tcg_precision=(
            jax.lax.Precision.HIGHEST if cfg.rtr_tcg_precision == "highest"
            else jax.lax.Precision.HIGH if cfg.rtr_tcg_precision == "high"
            else None
        ),
    )
    X_new = jnp.where(do_opt, Xopt, X0)
    outgoing_only = a_shared[5].astype(X0.dtype)
    cost = _edge_cost_terms(X0, nbr_poses, lp, outgoing_only)
    # the solver already evaluated the Riemannian gradient norm at X0
    return X_new, stats.gnorm_init, cost


def _agent_eval(
    problem: SPMDProblem,
    cfg: SPMDConfig,
    qd_static,
    X0: jax.Array,
    a_priv, a_shared,
    nbr_poses: jax.Array,
):
    """Selection/termination metrics at X0 only — no local solve. Matches
    _agent_round's gradnorm convention exactly (same control-path flags), so
    greedy selection and team termination behave identically whether an
    agent's metrics come from its solver or from this cheap pass."""
    lp = _agent_local_problem(problem, a_priv, a_shared)
    G = quadratic.build_linear_term(lp, nbr_poses, r=problem.r)
    res = (
        quadratic.build_residual_data(lp, nbr_poses)
        if cfg.rtr_residual_control else None
    )
    qd = dataclasses.replace(qd_static, G=G, res=res)
    _, gnorm = rtr_mod.initial_cost_gradnorm(
        qd, X0,
        inner_dtype=jnp.dtype(cfg.rtr_inner_dtype) if cfg.rtr_inner_dtype else None,
        inner_control_matvecs=cfg.rtr_inner_control_matvecs,
        residual_control=cfg.rtr_residual_control,
    )
    cost = _edge_cost_terms(X0, nbr_poses, lp, a_shared[5].astype(X0.dtype))
    return gnorm, cost


# ---------------------------------------------------------------------------
# The SPMD round (runs under shard_map; axis_name=None for single-program)
# ---------------------------------------------------------------------------

def _gather_pub(X_blk, pub_idx_blk, axis_name):
    """Collect every agent's public poses: (N, p_max, r, dh), replicated."""
    pub = jax.vmap(lambda Xa, idx: Xa[idx])(X_blk, pub_idx_blk)
    if axis_name is None:
        return pub
    return jax.lax.all_gather(pub, axis_name, axis=0, tiled=True)


def _psum(x, axis_name):
    return x if axis_name is None else jax.lax.psum(x, axis_name)


def _device_put_problem(problem: SPMDProblem, mesh: Mesh) -> SPMDProblem:
    """Lay out the problem on the mesh: agent-sharded data fields, replicated
    membership vector."""
    blk = NamedSharding(mesh, P("agents"))
    rep = NamedSharding(mesh, P())
    kwargs = {
        f: jax.device_put(
            getattr(problem, f), rep if f in _REPLICATED_FIELDS else blk
        )
        for f in _DATA_FIELDS
    }
    return dataclasses.replace(problem, **kwargs)


def _round_body(problem_blk: SPMDProblem, cfg: SPMDConfig, axis_name,
                agent_offset, state_blk: SPMDState, sel: jax.Array,
                qd_static=None):
    """One synchronous round for this device's block of agents.

    sel: int32 — selected agent id for 'greedy'/'uniform' modes, or -1 for
    'all'. agent_offset: global id of this device's first agent. qd_static:
    prebuilt round-invariant per-agent data (see _build_qd_static); built
    here when not supplied.
    """
    pr = problem_blk
    if qd_static is None:
        qd_static = _build_qd_static(problem_blk, cfg)
    A = pr.priv_i.shape[0]  # agents on this device
    N = pr.num_agents
    dtype = state_blk.X.dtype

    a_priv = (pr.priv_i, pr.priv_j, pr.priv_T, pr.priv_kappa, pr.priv_tau,
              pr.priv_weight, pr.priv_lane)
    a_shared = (pr.shared_idx, pr.shared_T, pr.shared_kappa, pr.shared_tau,
                pr.shared_weight, pr.shared_outgoing,
                _shared_activity_mask(pr, cfg))

    agent_ids = agent_offset + jnp.arange(A, dtype=jnp.int32)
    # this device's agents' activity: inactive robots never optimize and
    # their blocks stay frozen (reference: PGOAgent.cpp:1173-1184)
    active_blk = pr.robot_active[agent_ids]
    if cfg.mode == "async":
        # Poisson thinning: draw the whole team's firing mask from a
        # round-indexed key (identical on every device — deterministic and
        # mesh-consistent), then slice this device's agents.
        p_fire = 1.0 - float(np.exp(-cfg.async_rate))
        mask_all = jax.random.bernoulli(
            jax.random.fold_in(jax.random.PRNGKey(cfg.seed), state_blk.it),
            p_fire, (N,),
        )
        do_opt = mask_all[agent_ids]
    else:
        do_opt = jnp.where(sel < 0, jnp.ones(A, bool), agent_ids == sel)
    do_opt = jnp.logical_and(do_opt, active_blk)

    def resolve_nbr(all_pub):
        # (A, ms, r, dh) gather of each shared edge's neighbor pose
        return all_pub[pr.shared_nbr_robot, pr.shared_nbr_slot]

    # Nesterov aux-variable projection: exact batched SVD in full precision,
    # or the SVD-free Newton-Schulz polar (mixed mode, batched matmuls
    # only). The projected Y/V feed the iterate itself, so full-precision
    # ORTHONORMALITY is required — pure-f32 projections floor the reachable
    # global gradient norm at ~2e-2. The default runs the NS bulk in f32
    # with a 2-step full-precision polish (ops/lifted.py
    # project_stiefel_ns_mixed). Set ns_projection_dtype='float32' for the
    # pure-f32 kernel, or 'float64' for the full-precision chain.
    if cfg.rtr_inner_dtype:
        if cfg.ns_projection_dtype == "float32":
            project = lambda M: lifted.project_lifted_ns(
                M.astype(jnp.float32)
            ).astype(M.dtype)
        elif cfg.ns_projection_dtype in ("float64", "full"):
            project = lifted.project_lifted_ns
        else:
            project = lifted.project_lifted_ns_mixed
    elif dtype == jnp.float32:
        # pure-f32 state: Newton-Schulz (batched matmuls, no iterative
        # batched SVD)
        project = lifted.project_lifted_ns
    else:
        project = lifted.project_lifted

    def team_cost(X_blk, nbr_blk):
        """Global objective at a team iterate (psum of per-agent edge costs)."""
        lp_cost = jax.vmap(
            lambda Xa, priv, shared, nbr: _edge_cost_terms(
                Xa, nbr,
                _agent_local_problem(pr, priv, shared),
                shared[5].astype(Xa.dtype),
            )
        )(X_blk, a_priv, a_shared, nbr_blk)
        return _psum(jnp.sum(lp_cost), axis_name)

    def solve_team(X_from, nbr_from):
        """This round's local solves: (X_upd, gnorm_a, cost_a).

        Single-selection modes on a single device run the expensive RTR
        solve ONLY on the selected agent's block (dynamic slice + scatter);
        every other agent pays one cheap metric pass (_agent_eval). This is
        the reference's work profile — non-selected robots do no local
        optimization (MultiRobotExample.cpp:170-207) — where the vmapped
        path would solve all A blocks and discard A-1 of them. On a mesh
        the vmapped path stays: blocks solve on separate devices in
        parallel, so there is no wall-clock waste to remove.
        """
        if cfg.mode in ("greedy", "uniform") and axis_name is None:

            def _one_selected(ops):
                X_f, nbr_f = ops
                gnorm_a, cost_a = jax.vmap(
                    partial(_agent_eval, pr, cfg)
                )(qd_static, X_f, a_priv, a_shared, nbr_f)
                sel_c = jnp.clip(sel, 0, A - 1)
                take = lambda t: jax.tree.map(lambda x: x[sel_c], t)
                do_sel = jnp.logical_and(sel >= 0, active_blk[sel_c])
                X_sel, _, _ = _agent_round(
                    pr, cfg, take(qd_static), X_f[sel_c],
                    take(a_priv), take(a_shared), nbr_f[sel_c], do_sel,
                )
                X_upd = X_f.at[sel_c].set(
                    jnp.where(do_sel, X_sel, X_f[sel_c])
                )
                return X_upd, gnorm_a, cost_a

            def _all_agents(ops):
                X_f, nbr_f = ops
                return jax.vmap(partial(_agent_round, pr, cfg))(
                    qd_static, X_f, a_priv, a_shared, nbr_f, do_opt
                )

            # sel = -1 is the documented 'all agents optimize' sentinel and
            # must keep the same semantics on one device as on the mesh
            # (where the vmapped path always runs)
            return jax.lax.cond(
                sel >= 0, _one_selected, _all_agents, (X_from, nbr_from)
            )
        return jax.vmap(partial(_agent_round, pr, cfg))(
            qd_static, X_from, a_priv, a_shared, nbr_from, do_opt
        )

    if cfg.acceleration:
        # Restart = the reference's restartNesterovAcceleration
        # (PGOAgent.cpp:887-897): revert to the round-start X, re-solve
        # WITHOUT acceleration, then reset gamma/Y/V. Since the accelerated
        # result of a restart round is fully discarded there, we skip it and
        # run the plain solve directly, saving one local solve. Small
        # intentional protocol difference: the reference's restart re-solve
        # consumes the aux (Y) neighbor poses received that iteration, while
        # this round exchanges and solves against plain X poses (Y == X on
        # restart rounds here).
        periodic = (state_blk.it + 1) % cfg.restart_interval == 0
        if cfg.adaptive_restart:
            restart = jnp.logical_or(periodic, state_blk.do_restart)
        else:
            restart = periodic
        # gamma/alpha recursions are global scalars (PGOAgent.cpp:910-920)
        Nn = N if cfg.nesterov_n is None else cfg.nesterov_n
        gamma = (1.0 + jnp.sqrt(1.0 + 4.0 * Nn**2 * state_blk.gamma**2)) / (2.0 * Nn)
        alpha = 1.0 / (gamma * Nn)
        Y_acc = project((1.0 - alpha) * state_blk.X + alpha * state_blk.V)
        Y = jnp.where(restart, state_blk.X, Y_acc)
        # aux public poses come from Y (PGOAgent.cpp:132-166); on restart
        # rounds Y == X, so the gather delivers the plain neighbor poses.
        all_pub_aux = _gather_pub(Y, pr.pub_idx, axis_name)
        nbr_aux = resolve_nbr(all_pub_aux)
        X_upd, gnorm_a, cost_a = solve_team(Y, nbr_aux)
        # non-optimizing agents take X <- Y (PGOAgent.cpp:943-947);
        # INACTIVE agents stay exactly frozen
        act = active_blk[:, None, None, None]
        X_upd = jnp.where(act, X_upd, state_blk.X)
        V = jnp.where(
            restart, X_upd, project(state_blk.V + gamma * (X_upd - Y))
        )
        V = jnp.where(act, V, state_blk.X)
        gamma = jnp.where(restart, 0.0, gamma)
        Y_out = jnp.where(act, jnp.where(restart, X_upd, Y), state_blk.X)
        if cfg.adaptive_restart:
            # function-scheme adaptive restart: request a restart next round
            # whenever the objective at the new X increased over the last one
            nbr_new = resolve_nbr(_gather_pub(X_upd, pr.pub_idx, axis_name))
            cost_new = team_cost(X_upd, nbr_new)
            do_restart_next = cost_new > state_blk.cost_X * (
                1 + cfg.restart_cost_rtol
            )
            cost_X_next = cost_new
        else:
            do_restart_next = jnp.asarray(False)
            cost_X_next = state_blk.cost_X
        new_state = SPMDState(
            X=X_upd, Y=Y_out, V=V,
            gamma=jnp.asarray(gamma, dtype),
            it=state_blk.it + 1,
            cost_X=cost_X_next,
            do_restart=do_restart_next,
        )
    else:
        all_pub = _gather_pub(state_blk.X, pr.pub_idx, axis_name)
        nbr = resolve_nbr(all_pub)
        X_upd, gnorm_a, cost_a = solve_team(state_blk.X, nbr)
        X_upd = jnp.where(active_blk[:, None, None, None], X_upd, state_blk.X)
        new_state = SPMDState(
            X=X_upd, Y=X_upd, V=X_upd,
            gamma=state_blk.gamma, it=state_blk.it + 1,
            cost_X=state_blk.cost_X, do_restart=jnp.asarray(False),
        )

    # inactive robots are excluded from every team metric (reference:
    # shouldTerminate and statistics() skip inactive robots,
    # PGOAgent.cpp:860-861, PoseGraph.cpp:320-327); their shared edges are
    # already masked out of cost/gradient via _shared_activity_mask
    act_f = active_blk.astype(dtype)
    gnorm_a = gnorm_a * act_f
    cost_a = cost_a * act_f
    rel = jax.vmap(lifted.max_translation_distance)(new_state.X, state_blk.X)
    metrics = RoundMetrics(
        cost=_psum(jnp.sum(cost_a), axis_name),
        gradnorm=jnp.sqrt(_psum(jnp.sum(gnorm_a**2), axis_name)),
        max_rel_change=jax.lax.pmax(jnp.max(rel), axis_name)
        if axis_name is not None
        else jnp.max(rel),
    )
    return new_state, metrics, gnorm_a


def _select_next(gnorm_all: jax.Array, cfg: SPMDConfig, it, key):
    """Next selected agent: greedy argmax block gradnorm or uniform."""
    if cfg.mode == "greedy":
        return jnp.argmax(gnorm_all).astype(jnp.int32)
    if cfg.mode == "uniform":
        return jax.random.randint(
            jax.random.fold_in(key, it), (), 0, gnorm_all.shape[0], jnp.int32
        )
    return jnp.asarray(-1, jnp.int32)


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

def _validate_cfg(cfg: SPMDConfig) -> None:
    if cfg.mode not in ("all", "greedy", "uniform", "async"):
        raise ValueError(f"unknown SPMD mode {cfg.mode!r}")
    if cfg.restart_scheme not in ("cost", "exact", "gradient"):
        # a typo (e.g. env DPGO_SCALE_RESTART_SCHEME=exct) must not silently
        # fall through to the noisy 'cost' branch in delta._delta_round
        raise ValueError(f"unknown restart_scheme {cfg.restart_scheme!r}")
    if cfg.mode == "async" and cfg.acceleration:
        # the reference forbids acceleration in asynchronous mode
        # (PGOAgent.cpp:477) — the Nesterov recursions assume synchronized
        # global round counters
        raise ValueError("acceleration is not supported in async mode")


def make_step_fn(problem: SPMDProblem, cfg: SPMDConfig, mesh: Optional[Mesh] = None):
    """Build the jitted one-round step: state -> (state, metrics).

    With a mesh, the state and problem are sharded along the agent axis and
    the round runs under shard_map ('agents' collectives). Without a
    mesh, the same math runs as a single-device batched program.
    """
    _validate_cfg(cfg)
    N = problem.num_agents
    key = jax.random.PRNGKey(cfg.seed)
    splan, b_arrays = _plan_banded_static(problem, cfg)
    cfg_build = (dataclasses.replace(cfg, precond="jacobi")
                 if splan is not None else cfg)

    def build_static(pr_blk, b_arr):
        qd_static = _build_qd_static(pr_blk, cfg_build)
        if splan is not None:
            qd_static = _attach_banded_static(pr_blk, qd_static, splan, b_arr)
        return qd_static

    if mesh is None:
        def step(state: SPMDState, sel: jax.Array):
            qd_static = build_static(problem, b_arrays)
            new_state, metrics, gnorm_a = _round_body(
                problem, cfg, None, jnp.asarray(0, jnp.int32), state, sel,
                qd_static,
            )
            nxt = _select_next(gnorm_a, cfg, state.it, key)
            return new_state, metrics, nxt

        return jax.jit(step)

    n_dev = mesh.devices.size
    assert N % n_dev == 0, (
        f"num_agents {N} must be a multiple of mesh size {n_dev}"
    )
    A = N // n_dev

    blk_spec = P("agents")
    rep = P()

    def sharded_step(pr_blk: SPMDProblem, b_arr, state_blk: SPMDState, sel):
        dev = jax.lax.axis_index("agents")
        offset = (dev * A).astype(jnp.int32)
        qd_static = build_static(pr_blk, b_arr)
        new_state, metrics, gnorm_a = _round_body(
            pr_blk, cfg, "agents", offset, state_blk, sel, qd_static
        )
        gnorm_all = jax.lax.all_gather(gnorm_a, "agents", axis=0, tiled=True)
        nxt = _select_next(gnorm_all, cfg, state_blk.it, key)
        return new_state, metrics, nxt

    state_specs = SPMDState(
        X=blk_spec, Y=blk_spec, V=blk_spec, gamma=rep, it=rep,
        cost_X=rep, do_restart=rep,
    )
    problem_specs = SPMDProblem(
        num_agents=N, n_max=problem.n_max, d=problem.d, r=problem.r,
        num_band=problem.num_band, band_offsets=problem.band_offsets,
        **{f: (rep if f in _REPLICATED_FIELDS else blk_spec)
           for f in _DATA_FIELDS},
    )
    barr_specs = tuple(blk_spec for _ in b_arrays)
    fn = jax.shard_map(
        sharded_step,
        mesh=mesh,
        in_specs=(problem_specs, barr_specs, state_specs, rep),
        out_specs=(state_specs, RoundMetrics(rep, rep, rep), rep),
        check_vma=False,
    )

    problem_dev = _device_put_problem(problem, mesh)

    @jax.jit
    def step(state: SPMDState, sel: jax.Array):
        return fn(problem_dev, b_arrays, state, sel)

    return step


@jax.jit
def _gnc_residuals_sq(problem: SPMDProblem, state: SPMDState):
    """Squared lifted residuals of all edges: ((N, mp), (N, ms)). Padded edges
    report 0 (kappa = tau = 0)."""
    pr = problem
    d = pr.d
    X = state.X
    all_pub = _gather_pub(X, pr.pub_idx, None)
    nbr = all_pub[pr.shared_nbr_robot, pr.shared_nbr_slot]

    hi = jax.lax.Precision.HIGHEST
    Yi = jnp.take_along_axis(X, pr.priv_i[:, :, None, None], axis=1)
    Yj = jnp.take_along_axis(X, pr.priv_j[:, :, None, None], axis=1)
    rot = jnp.sum((jnp.einsum("qmra,qmab->qmrb", Yi[..., :d], pr.priv_T[..., :d, :d], precision=hi) - Yj[..., :d]) ** 2, axis=(-2, -1))
    tr = jnp.sum(
        (jnp.einsum("qmra,qmab->qmrb", Yi[..., :d], pr.priv_T[..., :d, d:], precision=hi)
         + Yi[..., d:] - Yj[..., d:]) ** 2,
        axis=(-2, -1),
    )
    r_sq_priv = pr.priv_kappa * rot + pr.priv_tau * tr

    Xl = jnp.take_along_axis(X, pr.shared_idx[:, :, None, None], axis=1)
    tail = jnp.where(pr.shared_outgoing[..., None, None], Xl, nbr)
    head = jnp.where(pr.shared_outgoing[..., None, None], nbr, Xl)
    rot_s = jnp.sum(
        (jnp.einsum("qmra,qmab->qmrb", tail[..., :d], pr.shared_T[..., :d, :d], precision=hi)
         - head[..., :d]) ** 2, axis=(-2, -1))
    tr_s = jnp.sum(
        (jnp.einsum("qmra,qmab->qmrb", tail[..., :d], pr.shared_T[..., :d, d:], precision=hi)
         + tail[..., d:] - head[..., d:]) ** 2,
        axis=(-2, -1),
    )
    r_sq_shared = pr.shared_kappa * rot_s + pr.shared_tau * tr_s
    return r_sq_priv, r_sq_shared


def _apply_gnc_weights(problem: SPMDProblem, r_sq_priv, r_sq_shared,
                       barc_sq, mu) -> SPMDProblem:
    """GNC-TLS weight update from precomputed squared residuals — the rule
    shared by the plain engine (lifted residuals at X) and the delta engine
    (residual-form at anchor + D). Weights of fixed-weight edges (odometry)
    are untouched; shared edges to an INACTIVE neighbor keep their last
    weight — the reference skips inactive robots in weight updates
    (PGOAgent.cpp:1015-1016); their cached pose may be stale, so the
    residual is not trustworthy."""
    from dpgo_tpu.robust import gnc_tls_weights as _w

    new_priv_w = jnp.where(
        problem.priv_fixed_weight, problem.priv_weight, _w(r_sq_priv, barc_sq, mu)
    )
    nbr_inactive = ~problem.robot_active[problem.shared_nbr_robot]
    new_shared_w = jnp.where(
        problem.shared_fixed_weight | nbr_inactive,
        problem.shared_weight, _w(r_sq_shared, barc_sq, mu)
    )
    return dataclasses.replace(
        problem, priv_weight=new_priv_w, shared_weight=new_shared_w
    )


@jax.jit
def gnc_reweight(problem: SPMDProblem, state: SPMDState, barc_sq, mu) -> SPMDProblem:
    """Distributed GNC-TLS measurement reweighting as one jitted program
    (reference: PGOAgent.cpp:1062-1142, computeMeasurementResidual +
    updateMeasurementWeights, lowered to batched array ops).

    Residuals are evaluated in the lifted space at the current X (private
    edges) and against the *current public poses* (shared edges). Runs
    replicated — each agent block depends only on its own rows + the
    gathered public poses, so the same function works under shard_map.
    """
    r_sq_priv, r_sq_shared = _gnc_residuals_sq(problem, state)
    return _apply_gnc_weights(problem, r_sq_priv, r_sq_shared, barc_sq, mu)


def run_rbcd_gnc(
    problem: SPMDProblem,
    state: SPMDState,
    cfg: SPMDConfig,
    barc: float = 5.0,
    init_mu: Optional[float] = None,
    mu_step: float = 1.4,
    num_weight_updates: int = 10,
    inner_rounds: int = 30,
    rel_change_tol: float = 5e-3,
    mesh: Optional[Mesh] = None,
):
    """Distributed GNC-TLS: alternate RBCD with team-wide weight updates and
    a growing mu (reference's distributed robust schedule,
    PGOAgent.cpp:997-1142).

    Weight updates are convergence-gated like the reference's
    shouldUpdateMeasurementWeights (PGOAgent.cpp:997-1046): each inner phase
    runs until the team-wide max relative change drops below rel_change_tol
    (= every agent readyToTerminate) or the `inner_rounds` budget is
    exhausted, whichever comes first. Before the first weight update the
    loose threshold 5.0 is used (PGOAgent.cpp:411-415).

    init_mu=None uses the adaptive initialization of the reference's batch
    GNC (DPGO_solver.cpp:356-358): mu0 = barc^2 / (2 max r^2 - barc^2),
    computed at the first converged iterate — gentle annealing when the
    initial guess is outlier-polluted. Returns (problem, state, history)."""
    barc_sq = barc * barc
    run = make_run_fn(problem, cfg, mesh)
    mu = init_mu
    history = []
    for k in range(num_weight_updates):
        # pass the CURRENT problem: weights updated by gnc_reweight must be
        # seen by the inner optimization (same shapes -> no recompile)
        rel_tol = 5.0 if k == 0 else rel_change_tol
        state, metrics, rounds = run(
            state, inner_rounds, 0.0, problem=problem, rel_tol=rel_tol
        )
        if mu is None:
            r_sq_p, r_sq_s = _gnc_residuals_sq(problem, state)
            r_max = float(jnp.maximum(jnp.max(r_sq_p), jnp.max(r_sq_s)))
            mu = barc_sq / max(2.0 * r_max - barc_sq, barc_sq * 1e-3)
        problem = gnc_reweight(problem, state, barc_sq, mu)
        mu *= mu_step
        history.append(
            {"rounds": int(rounds), "cost": float(metrics.cost), "mu": mu}
        )
    return problem, state, history


def edge_weight_table(problem: SPMDProblem, ranges):
    """Host-side diagnostic: recover every real edge's GLOBAL (p1, p2) pair
    with its current GNC weight and fixed flag. Used to score outlier
    rejection precision/recall against a planted-outlier ground truth
    (bench.py intel-gnc-outliers; the reference never scores its GNC path —
    its examples run clean inputs only, SingleRobotGNCExample.cpp).

    Private edges appear once; shared edges once per endpoint copy (the GNC
    update drives both copies identically — gnc_reweight reweights from the
    same team-wide residuals). Ordered pairs: (tail, head) as measured.
    Returns a list of dicts {pair, weight, fixed, shared}.
    """
    starts = np.asarray([s for s, _ in ranges], np.int64)
    out = []
    pk = np.asarray(problem.priv_kappa)
    pi = np.asarray(problem.priv_i)
    pj = np.asarray(problem.priv_j)
    pw = np.asarray(problem.priv_weight)
    pfx = np.asarray(problem.priv_fixed_weight)
    sk = np.asarray(problem.shared_kappa)
    sidx = np.asarray(problem.shared_idx)
    sw = np.asarray(problem.shared_weight)
    sfx = np.asarray(problem.shared_fixed_weight)
    sout = np.asarray(problem.shared_outgoing)
    snr = np.asarray(problem.shared_nbr_robot)
    sns = np.asarray(problem.shared_nbr_slot)
    pub = np.asarray(problem.pub_idx)
    A = pk.shape[0]
    for a in range(A):
        real = pk[a] > 0
        for k in np.nonzero(real)[0]:
            out.append({
                "pair": (int(starts[a] + pi[a, k]),
                         int(starts[a] + pj[a, k])),
                "weight": float(pw[a, k]), "fixed": bool(pfx[a, k]),
                "shared": False,
            })
        real_s = sk[a] > 0
        for k in np.nonzero(real_s)[0]:
            local_g = int(starts[a] + sidx[a, k])
            nbr_g = int(starts[snr[a, k]] + pub[snr[a, k], sns[a, k]])
            pair = ((local_g, nbr_g) if sout[a, k] else (nbr_g, local_g))
            out.append({
                "pair": pair, "weight": float(sw[a, k]),
                "fixed": bool(sfx[a, k]), "shared": True,
            })
    return out


def make_run_fn(problem: SPMDProblem, cfg: SPMDConfig, mesh: Optional[Mesh] = None):
    """Build a fully-jitted run-to-tolerance driver: the entire RBCD
    optimization — all rounds, including nested RTR/tCG — is ONE compiled XLA
    program with a lax.while_loop over rounds. Zero host round trips: no
    per-round dispatch and no device-to-host metric transfers.

    The round-invariant data matrices (Q blocks + preconditioner factors) are
    assembled ONCE before the loop; each round rebuilds only the linear term
    G from the exchanged neighbor poses — mirroring the reference's
    std::optional caching (PoseGraph.h:325-331).

    Returns run(state, max_rounds, tol, problem=<build-time problem>)
    -> (state, last_metrics, rounds). The problem is a runtime argument (same
    shapes -> no recompile), so weight updates (GNC) take effect — pass the
    reweighted problem on each call. The termination check uses the
    round-start global gradient norm (the same quantity the in-process
    simulation checks).
    """
    _validate_cfg(cfg)
    N = problem.num_agents
    key = jax.random.PRNGKey(cfg.seed)
    # exact per-agent banded preconditioner (host-side plan, factor built
    # inside the jit from runtime weights); when unavailable the build falls
    # back to cfg.precond's in-jit resolution (tridiag/jacobi)
    splan, b_arrays = _plan_banded_static(problem, cfg)
    cfg_build = (dataclasses.replace(cfg, precond="jacobi")
                 if splan is not None else cfg)

    def build_static(pr_blk, b_arr):
        qd_static = _build_qd_static(pr_blk, cfg_build)
        if splan is not None:
            qd_static = _attach_banded_static(pr_blk, qd_static, splan, b_arr)
        return qd_static

    def make_loop(axis_name, agent_offset, pr_blk, qd_static):
        def cond(carry):
            state, metrics, sel, rounds, max_rounds, tol, rel_tol = carry
            more = jnp.logical_and(rounds < max_rounds, metrics.gradnorm >= tol)
            # team-wide relative-change termination (the reference's
            # readyToTerminate gate, PGOAgent.cpp:402-421); rel_tol=0
            # disables it
            return jnp.logical_and(more, metrics.max_rel_change >= rel_tol)

        def body(carry):
            state, _metrics, sel, rounds, max_rounds, tol, rel_tol = carry
            new_state, metrics, gnorm_a = _round_body(
                pr_blk, cfg, axis_name, agent_offset, state, sel, qd_static
            )
            if axis_name is None:
                gnorm_all = gnorm_a
            else:
                gnorm_all = jax.lax.all_gather(gnorm_a, axis_name, axis=0, tiled=True)
            nxt = _select_next(gnorm_all, cfg, state.it, key)
            return (new_state, metrics, nxt, rounds + 1, max_rounds, tol, rel_tol)

        return cond, body

    def init_carry(state, max_rounds, tol, rel_tol):
        dtype = state.X.dtype
        metrics0 = RoundMetrics(
            cost=jnp.asarray(jnp.inf, dtype),
            gradnorm=jnp.asarray(jnp.inf, dtype),
            max_rel_change=jnp.asarray(jnp.inf, dtype),
        )
        sel0 = jnp.asarray(-1 if cfg.mode in ("all", "async") else 0, jnp.int32)
        return (state, metrics0, sel0, jnp.asarray(0, jnp.int32),
                jnp.asarray(max_rounds, jnp.int32), jnp.asarray(tol, dtype),
                jnp.asarray(rel_tol, dtype))

    if mesh is None:
        @jax.jit
        def _run(pr, b_arr, state, max_rounds, tol, rel_tol):
            qd_static = build_static(pr, b_arr)
            cond, body = make_loop(None, jnp.asarray(0, jnp.int32), pr, qd_static)
            state, metrics, _sel, rounds, *_ = jax.lax.while_loop(
                cond, body, init_carry(state, max_rounds, tol, rel_tol)
            )
            return state, metrics, rounds

        def run(state, max_rounds, tol, problem=problem, rel_tol=0.0):
            return _run(problem, b_arrays, state, max_rounds, tol, rel_tol)

        return run

    n_dev = mesh.devices.size
    assert N % n_dev == 0
    A = N // n_dev
    blk_spec = P("agents")
    rep = P()

    def sharded_run(pr_blk, b_arr, state_blk, max_rounds, tol, rel_tol):
        dev = jax.lax.axis_index("agents")
        offset = (dev * A).astype(jnp.int32)
        qd_static = build_static(pr_blk, b_arr)
        cond, body = make_loop("agents", offset, pr_blk, qd_static)
        state, metrics, _sel, rounds, *_ = jax.lax.while_loop(
            cond, body, init_carry(state_blk, max_rounds, tol, rel_tol)
        )
        return state, metrics, rounds

    state_specs = SPMDState(X=blk_spec, Y=blk_spec, V=blk_spec, gamma=rep, it=rep,
                            cost_X=rep, do_restart=rep)
    problem_specs = SPMDProblem(
        num_agents=N, n_max=problem.n_max, d=problem.d, r=problem.r,
        num_band=problem.num_band, band_offsets=problem.band_offsets,
        **{f: (rep if f in _REPLICATED_FIELDS else blk_spec)
           for f in _DATA_FIELDS},
    )
    barr_specs = tuple(blk_spec for _ in b_arrays)
    fn = jax.shard_map(
        sharded_run,
        mesh=mesh,
        in_specs=(problem_specs, barr_specs, state_specs, rep, rep, rep),
        out_specs=(state_specs, RoundMetrics(rep, rep, rep), rep),
        check_vma=False,
    )
    @jax.jit
    def _run(pr, b_arr, state, max_rounds, tol, rel_tol):
        return fn(pr, b_arr, state, max_rounds, tol, rel_tol)

    def run(state, max_rounds, tol, problem=problem, rel_tol=0.0):
        return _run(_device_put_problem(problem, mesh), b_arrays, state,
                    max_rounds, tol, rel_tol)

    return run


def make_two_phase_run_fn(
    problem: SPMDProblem,
    cfg: SPMDConfig,
    mesh: Optional[Mesh] = None,
    switch_factor: float = 4.0,
    chunk: int = 50,
):
    """Chunked run-to-tolerance driver with a fast/exact phase split for
    mixed precision: rounds run with inner-precision control matvecs
    (rtr_inner_control_matvecs=True, ~1.7x faster per round) until the
    global gradient norm drops below switch_factor * tol, then a program
    with full-precision control finishes the tail (the f32-computed
    gradient floors the reachable gradnorm around ~2e-2).

    The host checks the switch between launches of at most `chunk` rounds.
    Returns run(state, max_rounds, tol) -> (state, metrics, total_rounds).
    With a non-mixed cfg this degrades to a single-program chunked loop.
    """
    if cfg.rtr_inner_dtype is None:
        fns = [(make_run_fn(problem, cfg, mesh), 1.0)]
    else:
        cfg_fast = dataclasses.replace(cfg, rtr_inner_control_matvecs=True)
        cfg_tail = dataclasses.replace(cfg, rtr_inner_control_matvecs=False)
        fns = [
            (make_run_fn(problem, cfg_fast, mesh), switch_factor),
            (make_run_fn(problem, cfg_tail, mesh), 1.0),
        ]

    def run(state, max_rounds, tol, problem=problem, rel_tol=0.0):
        total = 0
        gradnorm = float("inf")
        metrics = None
        phase = 0
        while total < max_rounds and gradnorm >= tol:
            if phase < len(fns) - 1 and gradnorm < fns[phase][1] * tol:
                phase += 1
            fn, factor = fns[phase]
            state, metrics, rounds = fn(
                state, min(chunk, max_rounds - total), factor * tol,
                problem=problem, rel_tol=rel_tol,
            )
            total += int(rounds)
            # team-wide relative-change termination (reference
            # readyToTerminate semantics): the inner loop stopped early
            if int(rounds) < chunk and float(metrics.gradnorm) >= factor * tol:
                gradnorm = float(metrics.gradnorm)
                break
            gradnorm = float(metrics.gradnorm)
        return state, metrics, total

    def warmup(state):
        """Compile-and-run one round of every phase program."""
        out = state
        for fn, _ in fns:
            out, _, _ = fn(state, 1, 0.0)
        return out

    run.warmup = warmup
    return run


def run_rbcd_spmd(
    problem: SPMDProblem,
    state: SPMDState,
    cfg: SPMDConfig,
    num_rounds: int,
    mesh: Optional[Mesh] = None,
    gradnorm_tol: Optional[float] = None,
    check_every: int = 10,
):
    """Run synchronous RBCD rounds; host checks termination every
    `check_every` rounds (one device sync). Returns (state, trace dict)."""
    step = make_step_fn(problem, cfg, mesh)
    sel = jnp.asarray(-1 if cfg.mode in ("all", "async") else 0, jnp.int32)
    tol = cfg.gradnorm_tol if gradnorm_tol is None else gradnorm_tol

    costs, gnorms = [], []
    rounds = 0
    while rounds < num_rounds:
        burst = min(check_every, num_rounds - rounds)
        for _ in range(burst):
            state, metrics, sel = step(state, sel)
            rounds += 1
        costs.append(float(metrics.cost))
        gnorms.append(float(metrics.gradnorm))
        if gnorms[-1] < tol:
            break
    return state, {
        "rounds": rounds,
        "cost": costs,
        "gradnorm": gnorms,
    }


def save_state(state: SPMDState, path: str) -> None:
    """Checkpoint the SPMD optimizer state (npz). Complements the agent-level
    CSV checkpointing (io/logger.py) for the mesh-parallel path."""
    np.savez(
        path,
        X=np.asarray(state.X),
        Y=np.asarray(state.Y),
        V=np.asarray(state.V),
        gamma=np.asarray(state.gamma),
        it=np.asarray(state.it),
        cost_X=np.asarray(state.cost_X),
        do_restart=np.asarray(state.do_restart),
    )


def load_state(path: str) -> SPMDState:
    """Resume an SPMD optimizer state saved by save_state."""
    z = np.load(path)
    dtype = z["X"].dtype
    return SPMDState(
        X=jnp.asarray(z["X"]),
        Y=jnp.asarray(z["Y"]),
        V=jnp.asarray(z["V"]),
        gamma=jnp.asarray(z["gamma"]),
        it=jnp.asarray(z["it"]),
        # fields absent in pre-round-2 checkpoints
        cost_X=jnp.asarray(z["cost_X"]) if "cost_X" in z
        else jnp.asarray(np.inf, dtype),
        do_restart=jnp.asarray(z["do_restart"]) if "do_restart" in z
        else jnp.asarray(False),
    )


def assemble_global(
    state: SPMDState, ranges: List[Tuple[int, int]], num_poses: int
) -> np.ndarray:
    """(N, n_max, r, dh) sharded state -> global (n, r, dh) numpy iterate."""
    X = np.asarray(state.X)
    r, dh = X.shape[2], X.shape[3]
    out = np.zeros((num_poses, r, dh))
    for a, (s, e) in enumerate(ranges):
        out[s:e] = X[a, : e - s]
    return out

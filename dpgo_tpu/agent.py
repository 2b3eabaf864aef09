"""PGOAgent: the distributed RBCD protocol state machine.

Array-native counterpart of the reference's PGOAgent (include/DPGO/PGOAgent.h,
src/PGOAgent.cpp). Protocol semantics (state machine, pose/status exchange,
Nesterov acceleration, GNC weight scheduling, elastic membership, termination)
are host-side Python; all numerics run as jitted programs over static-shaped
arrays (quadratic.py + solvers/rtr.py). One compilation per local problem
shape; per-iteration work (neighbor updates, GNC weights) only changes array
values.

The core library contains no networking, exactly like the reference: callers
move pose dictionaries between agents (examples/, parallel/). The SPMD
mesh-parallel path lives in dpgo_tpu.parallel.
"""

from __future__ import annotations

import dataclasses
import math
import os
import threading
import time
from functools import partial
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dpgo_tpu import log
from dpgo_tpu import quadratic
from dpgo_tpu.io.logger import PGOLogger
from dpgo_tpu.measurements import (
    RelativeSEMeasurement,
    measurement_error,
)
from dpgo_tpu.ops import lifted
from dpgo_tpu.posegraph import PoseGraph
from dpgo_tpu.robust import RobustCost, angular_to_chordal_so3
from dpgo_tpu.solvers import averaging
from dpgo_tpu.solvers import pgo as pgo_mod
from dpgo_tpu.solvers import rtr as rtr_mod
from dpgo_tpu.types import (
    InitializationMethod,
    PGOAgentParameters,
    PGOAgentState,
    PGOAgentStatus,
    PoseID,
    ROptMethod,
    ROptParameters,
    ROPTResult,
    RobustCostParameters,
    RobustCostType,
)

PoseDict = Dict[PoseID, np.ndarray]


@partial(jax.jit, static_argnames=("r", "max_iterations", "max_inner", "shrink"))
def _solve_local(
    problem: quadratic.LocalProblem,
    nbr_poses: jax.Array,
    X0: jax.Array,
    r: int,
    gradnorm_tol: float,
    initial_radius: float,
    max_iterations: int,
    max_inner: int,
    shrink: bool,
):
    """Build data matrices + one local RTR solve, fused under one jit
    (replaces PoseGraph::constructDataMatrices + QuadraticOptimizer::optimize,
    reference: PGOAgent.cpp:938-995)."""
    qd = quadratic.build_quadratic_data(problem, nbr_poses, r=r)
    return rtr_mod.rtr_solve(
        qd,
        X0,
        gradnorm_tol=gradnorm_tol,
        initial_radius=initial_radius,
        max_iterations=max_iterations,
        max_inner=max_inner,
        shrink_until_accept=shrink,
    )


@partial(jax.jit, static_argnames=("r",))
def _rgd_local(
    problem: quadratic.LocalProblem,
    nbr_poses: jax.Array,
    X0: jax.Array,
    r: int,
    stepsize: float,
    use_precond: bool,
):
    qd = quadratic.build_quadratic_data(problem, nbr_poses, r=r)
    return rtr_mod.rgd_step(qd, X0, stepsize, use_precond)


class PGOAgent:
    """One robot of the distributed PGO team (reference: PGOAgent.h:242-772)."""

    def __init__(self, agent_id: int, params: PGOAgentParameters):
        self.id = agent_id
        self.params = params
        self.d = params.d
        self.r = params.r
        self.state = PGOAgentState.WAIT_FOR_DATA
        self.status = PGOAgentStatus(agent_id, self.state, 0, 0, False, 0.0)
        self.pose_graph = PoseGraph(agent_id, params.r, params.d)
        self.robust_cost = RobustCost(params.robust_cost_params)
        self.logger = PGOLogger(params.log_directory)

        self.X: Optional[np.ndarray] = None  # (n, r, d+1)
        self.X_init: Optional[np.ndarray] = None
        self.T_local_init: Optional[np.ndarray] = None  # (n, d, d+1)
        self.Y_lift: Optional[np.ndarray] = None
        self.global_anchor: Optional[np.ndarray] = None  # (r, d+1)

        # Nesterov acceleration variables (PGOAgent.h:731-748)
        self.gamma = 0.0
        self.alpha = 0.0
        self.Y: Optional[np.ndarray] = None
        self.V: Optional[np.ndarray] = None
        self.X_prev: Optional[np.ndarray] = None

        self.neighbor_pose_dict: PoseDict = {}
        self.neighbor_aux_pose_dict: PoseDict = {}
        self.team_status: Dict[int, PGOAgentStatus] = {}
        self.team_robot_active: List[bool] = [True] * params.num_robots

        self.instance_number = 0
        self.iteration_number = 0
        self.latest_weight_update_iteration = 0
        self.robust_opt_inner_iter = 0
        self.weight_update_count = 0
        self.trajectory_reset_count = 0

        self.publish_public_poses_requested = False
        self.publish_asynchronous_requested = False
        self.local_opt_result = ROPTResult()

        self._lock = threading.RLock()
        # Thread-lifecycle lock: guards _opt_thread start/join/observe. A
        # separate non-reentrant lock (NOT self._lock) because the loop thread
        # holds self._lock inside iterate() — joining under self._lock would
        # deadlock.
        self._thread_lock = threading.Lock()
        self._opt_thread: Optional[threading.Thread] = None
        self._end_loop_requested = False
        self._rng = np.random.default_rng()

        if self.id == 0:
            self.set_lifting_matrix(
                np.asarray(lifted.fixed_stiefel_variable(self.d, self.r))
            )

    # ------------------------------------------------------------------
    # Basic accessors
    # ------------------------------------------------------------------

    def get_id(self) -> int:
        return self.id

    def num_poses(self) -> int:
        return self.pose_graph.n

    def dimension(self) -> int:
        return self.d

    def relaxation_rank(self) -> int:
        return self.r

    def get_status(self) -> PGOAgentStatus:
        # refresh the state field on read (reference: PGOAgent.h:342-346)
        self.status.state = self.state
        return dataclasses.replace(self.status)

    def set_lifting_matrix(self, M: np.ndarray) -> None:
        M = np.asarray(M, np.float64)
        assert M.shape == (self.r, self.d)
        self.Y_lift = M

    def get_lifting_matrix(self) -> Optional[np.ndarray]:
        return None if self.Y_lift is None else self.Y_lift.copy()

    def set_global_anchor(self, M: np.ndarray) -> None:
        M = np.asarray(M, np.float64)
        assert M.shape == (self.r, self.d + 1)
        self.global_anchor = M

    # ------------------------------------------------------------------
    # Measurements
    # ------------------------------------------------------------------

    def add_measurement(self, factor: RelativeSEMeasurement) -> None:
        if self.state != PGOAgentState.WAIT_FOR_DATA:
            return
        with self._lock:
            self.pose_graph.add_measurement(factor)

    def set_measurements(
        self,
        odometry: List[RelativeSEMeasurement],
        private_loop_closures: List[RelativeSEMeasurement],
        shared_loop_closures: List[RelativeSEMeasurement],
    ) -> None:
        assert not self.is_optimization_running()
        assert self.state == PGOAgentState.WAIT_FOR_DATA
        if not odometry:
            return
        self.pose_graph = PoseGraph(self.id, self.r, self.d)
        self.pose_graph.set_measurements(
            list(odometry) + list(private_loop_closures) + list(shared_loop_closures)
        )

    def set_measurement_weight(
        self, src: PoseID, dst: PoseID, weight: float, fixed_weight: bool = False
    ) -> bool:
        m = self.pose_graph.find_measurement(src, dst)
        if m is None:
            return False
        with self._lock:
            m.weight = weight
            m.fixed_weight = fixed_weight
        return True

    # ------------------------------------------------------------------
    # Initialization (reference: PGOAgent.cpp:199-374)
    # ------------------------------------------------------------------

    def initialize(self, T_init: Optional[np.ndarray] = None) -> None:
        if self.state != PGOAgentState.WAIT_FOR_DATA:
            return
        self.end_optimization_loop()
        if self.pose_graph.n == 0:
            return
        n, d = self.pose_graph.n, self.d

        T = None
        if T_init is not None:
            T_init = np.asarray(T_init)
            if T_init.shape == (n, d, d + 1):
                T = T_init
        if T is None:
            method = self.params.local_initialization_method
            if method == InitializationMethod.Odometry:
                T = pgo_mod.odometry_initialization(self.pose_graph.odometry)
            elif method == InitializationMethod.Chordal:
                T = pgo_mod.chordal_initialization(self.pose_graph.local_measurements())
            elif method == InitializationMethod.GNC_TLS:
                T = self._gnc_local_initialization()
            else:
                raise ValueError(f"unknown initialization method {method}")
            if T.shape[0] != n:
                return  # wrong number of poses: fail initialization

        # Transform so the first pose is the identity (PGOAgent.cpp:281-289)
        T = np.asarray(T)
        Tw0_inv = np.asarray(lifted.se_inverse(T[0]))
        T = np.asarray(lifted.se_compose(Tw0_inv[None], T))
        self.T_local_init = T

        self.state = PGOAgentState.WAIT_FOR_INITIALIZATION
        if self.id == 0 or not self.params.multirobot_initialization:
            self.initialize_in_global_frame(np.hstack([np.eye(d), np.zeros((d, 1))]))
        if self.params.asynchronous:
            self.start_optimization_loop()

    def _gnc_local_initialization(self) -> np.ndarray:
        """GNC_TLS local init + hard rejection of outlier local loop closures
        (reference: PGOAgent.cpp:233-262)."""
        opt_params = ROptParameters(gradnorm_tol=1.0, RTR_iterations=20)
        robust_params = RobustCostParameters(
            cost_type=RobustCostType.GNC_TLS,
            GNC_max_iters=10,
            GNC_barc=5.0,
            GNC_mu_step=1.4,
        )
        params = pgo_mod.SolveRobustPGOParams(
            opt_params=opt_params,
            robust_params=robust_params,
            verbose=self.params.verbose,
        )
        T_odom = pgo_mod.odometry_initialization(self.pose_graph.odometry)
        T, mutated = pgo_mod.solve_robust_pgo(
            self.pose_graph.local_measurements(), params, T_odom
        )
        reject = 0
        for m in mutated:
            if m.weight < 1e-8:
                self.set_measurement_weight(
                    PoseID(m.r1, m.p1), PoseID(m.r2, m.p2), 0.0
                )
                reject += 1
        if self.params.verbose:
            log.info("Reject %d local loop closures.", reject)
        return T

    def initialize_in_global_frame(self, T_world_robot: np.ndarray) -> None:
        """Lift the local trajectory into the global frame
        (reference: PGOAgent.cpp:308-374)."""
        assert self.Y_lift is not None
        T_world_robot = np.asarray(T_world_robot)
        assert T_world_robot.shape == (self.d, self.d + 1)

        halted = False
        if self.is_optimization_running():
            halted = True
            self.end_optimization_loop()

        with self._lock:
            self.clear_neighbor_poses()
            T = np.asarray(
                lifted.se_compose(T_world_robot[None], self.T_local_init)
            )
            # X_i = Y_lift @ T_i : (r, d+1)
            self.X = np.einsum("rd,nde->nre", self.Y_lift, T)
            self.X_init = self.X.copy()
            self.state = PGOAgentState.INITIALIZED

            if self.params.robust_cost_params.cost_type != RobustCostType.L2:
                self.initialize_robust_optimization()
            if self.params.acceleration:
                self.initialize_acceleration()
            if self.params.log_data:
                self.logger.log_trajectory(
                    self.d, self.num_poses(), T, "trajectory_initial.csv"
                )
        if halted:
            self.start_optimization_loop()

    # ------------------------------------------------------------------
    # Iterate (reference: PGOAgent.cpp:376-432)
    # ------------------------------------------------------------------

    def iterate(self, do_optimization: bool = True) -> bool:
        self.iteration_number += 1
        if self.params.robust_cost_params.cost_type != RobustCostType.L2:
            self.robust_opt_inner_iter += 1

        success = True
        if self.state == PGOAgentState.INITIALIZED:
            self.X_prev = self.X.copy()
            if self.params.acceleration:
                self._update_gamma()
                self._update_alpha()
                self._update_Y()
                success = self._update_X(do_optimization, acceleration=True)
                self._update_V()
                if self.should_restart():
                    self.restart_nesterov_acceleration(do_optimization)
            else:
                success = self._update_X(do_optimization, acceleration=False)

            if do_optimization:
                self.status.agent_id = self.id
                self.status.state = self.state
                self.status.instance_number = self.instance_number
                self.status.iteration_number = self.iteration_number
                self.status.relative_change = float(
                    lifted.max_translation_distance(
                        jnp.asarray(self.X), jnp.asarray(self.X_prev)
                    )
                )
                ready = success
                rel_change_tol = self.params.rel_change_tol
                # Loose tolerance before the first weight update in robust mode
                # (PGOAgent.cpp:411-415).
                if (
                    self.params.robust_cost_params.cost_type != RobustCostType.L2
                    and self.weight_update_count == 0
                ):
                    rel_change_tol = 5.0
                if self.status.relative_change > rel_change_tol:
                    ready = False
                stat = self.pose_graph.statistics()
                if stat.total_loop_closures > 0:
                    ratio = (
                        stat.accept_loop_closures + stat.reject_loop_closures
                    ) / stat.total_loop_closures
                    if ratio < self.params.robust_opt_min_convergence_ratio:
                        ready = False
                self.status.ready_to_terminate = ready

            if do_optimization or self.params.acceleration:
                self.publish_public_poses_requested = True
            self.publish_asynchronous_requested = True
        return success

    def _update_X(self, do_optimization: bool, acceleration: bool) -> bool:
        """(reference: PGOAgent.cpp:938-995)."""
        with self._lock:
            if not do_optimization:
                if acceleration:
                    self.X = self.Y.copy()
                return True
            assert self.state == PGOAgentState.INITIALIZED

            if acceleration:
                self.pose_graph.set_neighbor_poses(self.neighbor_aux_pose_dict)
            else:
                self.pose_graph.set_neighbor_poses(self.neighbor_pose_dict)

            if not self.pose_graph.data_matrices_ready():
                self.local_opt_result = ROPTResult(success=False)
                return False

            problem, nbr_buf = self.pose_graph.local_problem()
            X0 = jnp.asarray(self.Y if acceleration else self.X)

            p = self.params.local_opt_params
            t0 = time.perf_counter()
            if p.method == ROptMethod.RTR:
                Xopt, stats = _solve_local(
                    problem,
                    jnp.asarray(nbr_buf),
                    X0,
                    r=self.r,
                    gradnorm_tol=p.gradnorm_tol,
                    initial_radius=p.RTR_initial_radius,
                    max_iterations=p.RTR_iterations,
                    max_inner=p.RTR_tCG_iterations,
                    shrink=(p.RTR_iterations == 1),
                )
                self.local_opt_result = ROPTResult(
                    success=True,
                    fInit=float(stats.f_init),
                    gradNormInit=float(stats.gnorm_init),
                    fOpt=float(stats.f_opt),
                    gradNormOpt=float(stats.gnorm_opt),
                    elapsedMs=(time.perf_counter() - t0) * 1e3,
                )
            else:
                Xopt = _rgd_local(
                    problem,
                    jnp.asarray(nbr_buf),
                    X0,
                    r=self.r,
                    stepsize=p.RGD_stepsize,
                    use_precond=p.RGD_use_preconditioner,
                )
                self.local_opt_result = ROPTResult(
                    success=True, elapsedMs=(time.perf_counter() - t0) * 1e3
                )
            self.X = np.asarray(Xopt)
            return True

    # ------------------------------------------------------------------
    # Nesterov acceleration (reference: PGOAgent.cpp:880-936)
    # ------------------------------------------------------------------

    def initialize_acceleration(self) -> None:
        assert self.params.acceleration
        if self.state == PGOAgentState.INITIALIZED:
            self.X_prev = self.X.copy()
            self.gamma = 0.0
            self.alpha = 0.0
            self.V = self.X.copy()
            self.Y = self.X.copy()

    def _update_gamma(self) -> None:
        N = self.params.num_robots
        self.gamma = (1 + math.sqrt(1 + 4 * N**2 * self.gamma**2)) / (2 * N)

    def _update_alpha(self) -> None:
        self.alpha = 1.0 / (self.gamma * self.params.num_robots)

    def _update_Y(self) -> None:
        M = (1 - self.alpha) * self.X + self.alpha * self.V
        self.Y = np.asarray(lifted.project_lifted(jnp.asarray(M)))

    def _update_V(self) -> None:
        M = self.V + self.gamma * (self.X - self.Y)
        self.V = np.asarray(lifted.project_lifted(jnp.asarray(M)))

    def should_restart(self) -> bool:
        if self.params.acceleration:
            return (self.iteration_number + 1) % self.params.restart_interval == 0
        return False

    def restart_nesterov_acceleration(self, do_optimization: bool) -> None:
        if self.params.acceleration and self.state == PGOAgentState.INITIALIZED:
            self.X = self.X_prev.copy()
            self._update_X(do_optimization, acceleration=False)
            self.V = self.X.copy()
            self.Y = self.X.copy()
            self.gamma = 0.0
            self.alpha = 0.0

    # ------------------------------------------------------------------
    # Pose exchange (reference: PGOAgent.cpp:97-166, 650-716)
    # ------------------------------------------------------------------

    def get_X(self) -> Optional[np.ndarray]:
        return None if self.X is None else self.X.copy()

    def set_X(self, X_in: np.ndarray) -> None:
        """(reference: PGOAgent.cpp:52-63). X_in: (n, r, d+1) or the flat
        reference layout (r, (d+1) n)."""
        with self._lock:
            assert self.state != PGOAgentState.WAIT_FOR_DATA
            X_in = np.asarray(X_in)
            if X_in.ndim == 2:
                X_in = np.asarray(
                    lifted.from_flat(X_in, self.num_poses(), self.d)
                )
            assert X_in.shape == (self.num_poses(), self.r, self.d + 1)
            self.state = PGOAgentState.INITIALIZED
            self.X = X_in.copy()
            if self.params.acceleration:
                self.initialize_acceleration()

    def set_X_to_initial_guess(self) -> None:
        assert self.state != PGOAgentState.WAIT_FOR_DATA
        assert self.X_init is not None
        self.X = self.X_init.copy()

    def get_shared_pose(self, index: int) -> Optional[np.ndarray]:
        if self.state != PGOAgentState.INITIALIZED or index >= self.num_poses():
            return None
        return self.X[index].copy()

    def get_aux_shared_pose(self, index: int) -> Optional[np.ndarray]:
        assert self.params.acceleration
        if self.state != PGOAgentState.INITIALIZED or index >= self.num_poses():
            return None
        return self.Y[index].copy()

    def get_shared_pose_dict(self) -> Optional[PoseDict]:
        if self.state != PGOAgentState.INITIALIZED:
            return None
        return {
            pid: self.X[pid.frame_id].copy()
            for pid in self.pose_graph.my_public_pose_ids()
        }

    def get_aux_shared_pose_dict(self) -> Optional[PoseDict]:
        assert self.params.acceleration
        if self.state != PGOAgentState.INITIALIZED:
            return None
        return {
            pid: self.Y[pid.frame_id].copy()
            for pid in self.pose_graph.my_public_pose_ids()
        }

    def get_shared_pose_dict_with_neighbor(self, neighbor_id: int) -> Optional[PoseDict]:
        if self.state != PGOAgentState.INITIALIZED:
            return None
        out: PoseDict = {}
        for m in self.pose_graph.shared_loop_closures_with(neighbor_id):
            if m.r1 == self.id:
                out[PoseID(m.r1, m.p1)] = self.X[m.p1].copy()
            elif m.r2 == self.id:
                out[PoseID(m.r2, m.p2)] = self.X[m.p2].copy()
        return out

    def get_aux_shared_pose_dict_with_neighbor(self, neighbor_id: int) -> Optional[PoseDict]:
        if self.state != PGOAgentState.INITIALIZED:
            return None
        out: PoseDict = {}
        for m in self.pose_graph.shared_loop_closures_with(neighbor_id):
            if m.r1 == self.id:
                out[PoseID(m.r1, m.p1)] = self.Y[m.p1].copy()
            elif m.r2 == self.id:
                out[PoseID(m.r2, m.p2)] = self.Y[m.p2].copy()
        return out

    def update_neighbor_poses(self, neighbor_id: int, pose_dict: PoseDict) -> None:
        """(reference: PGOAgent.cpp:650-678)."""
        assert neighbor_id != self.id
        if self.Y_lift is None:
            return
        if not self.has_neighbor_status(neighbor_id):
            return
        if self.get_neighbor_status(neighbor_id).state != PGOAgentState.INITIALIZED:
            return
        if self.state == PGOAgentState.WAIT_FOR_INITIALIZATION:
            T = self.compute_robust_neighbor_transform_two_stage(
                neighbor_id, pose_dict
            )
            if T is not None:
                self.initialize_in_global_frame(T)
        if self.state != PGOAgentState.INITIALIZED:
            return
        with self._lock:
            for pid, var in pose_dict.items():
                assert pid.robot_id == neighbor_id
                if not self.pose_graph.require_neighbor_pose(pid):
                    continue
                self.neighbor_pose_dict[pid] = np.asarray(var)

    def update_aux_neighbor_poses(self, neighbor_id: int, pose_dict: PoseDict) -> None:
        assert self.params.acceleration and neighbor_id != self.id
        if self.Y_lift is None or not self.has_neighbor_status(neighbor_id):
            return
        if self.get_neighbor_status(neighbor_id).state != PGOAgentState.INITIALIZED:
            return
        if self.state != PGOAgentState.INITIALIZED:
            return
        with self._lock:
            for pid, var in pose_dict.items():
                assert pid.robot_id == neighbor_id
                if not self.pose_graph.require_neighbor_pose(pid):
                    continue
                self.neighbor_aux_pose_dict[pid] = np.asarray(var)

    def clear_neighbor_poses(self) -> None:
        with self._lock:
            self.neighbor_pose_dict = {}
            self.neighbor_aux_pose_dict = {}

    def clear_active_neighbor_poses(self) -> None:
        with self._lock:
            for pid in self.pose_graph.active_neighbor_public_pose_ids():
                self.neighbor_pose_dict.pop(pid, None)
                self.neighbor_aux_pose_dict.pop(pid, None)

    # ------------------------------------------------------------------
    # Robust inter-robot initialization (reference: PGOAgent.cpp:515-648)
    # ------------------------------------------------------------------

    def compute_neighbor_transform(
        self, m: RelativeSEMeasurement, neighbor_pose: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Candidate alignment T_world2_world1 from one inter-robot loop
        closure (reference: PGOAgent.cpp:515-548). Returns (R, t)."""
        assert self.Y_lift is not None

        def inv(T):
            R, t = T[:, : self.d], T[:, self.d]
            return np.hstack([R.T, (-R.T @ t)[:, None]])

        def mul(Ta, Tb):
            Ra, ta = Ta[:, : self.d], Ta[:, self.d]
            Rb, tb = Tb[:, : self.d], Tb[:, self.d]
            return np.hstack([(Ra @ Rb), (Ra @ tb + ta)[:, None]])

        dT = np.hstack([m.R, m.t[:, None]])
        T_world2_frame2 = self.Y_lift.T @ np.asarray(neighbor_pose)
        T = self.T_local_init
        if m.r2 == self.id:
            T_frame1_frame2 = inv(dT)
            T_world1_frame1 = T[m.p2]
        else:
            T_frame1_frame2 = dT
            T_world1_frame1 = T[m.p1]
        T_world2_frame1 = mul(T_world2_frame2, inv(T_frame1_frame2))
        T_world2_world1 = mul(T_world2_frame1, inv(T_world1_frame1))
        return T_world2_world1[:, : self.d], T_world2_world1[:, self.d]

    def compute_robust_neighbor_transform(
        self, neighbor_id: int, pose_dict: PoseDict
    ) -> Optional[np.ndarray]:
        """One-stage robust inter-robot alignment: GNC-TLS single-POSE
        averaging over the candidate alignments, with the reference's
        hard-coded candidate precisions (rotation stddev ~30 deg -> kappa
        1.82, translation stddev 10 m -> tau 0.01) and a chi-squared 90%
        threshold (reference: PGOAgent.cpp:604-648; unused in the reference's
        default flow, which calls the two-stage variant). Returns
        T_world_robot (d, d+1) or None."""
        from dpgo_tpu.robust import error_threshold_at_quantile

        R_vec, t_vec = [], []
        for m in self.pose_graph.shared_loop_closures_with(neighbor_id):
            fid = m.p1 if m.r1 == neighbor_id else m.p2
            pid = PoseID(neighbor_id, fid)
            if pid in pose_dict:
                R, t = self.compute_neighbor_transform(m, pose_dict[pid])
                R_vec.append(R)
                t_vec.append(t)
        if not R_vec:
            return None
        n = len(R_vec)
        cbar = error_threshold_at_quantile(0.9, 3)
        R_opt, t_opt, inliers = averaging.robust_single_pose_averaging(
            R_vec, t_vec,
            kappa=1.82 * np.ones(n), tau=0.01 * np.ones(n),
            error_threshold=cbar,
        )
        if self.params.verbose:
            log.info(
                "Robot %d attempts initialization from neighbor %d: "
                "finds %d/%d inliers.",
                self.id, neighbor_id, len(inliers), n,
            )
        if len(inliers) < self.params.robust_init_min_inliers:
            return None
        return np.hstack([R_opt, t_opt[:, None]])

    def compute_robust_neighbor_transform_two_stage(
        self, neighbor_id: int, pose_dict: PoseDict
    ) -> Optional[np.ndarray]:
        """Robust rotation averaging over candidate alignments + translation
        averaging on inliers (reference: PGOAgent.cpp:550-602). Returns
        T_world_robot: (d, d+1) or None."""
        R_vec, t_vec = [], []
        for m in self.pose_graph.shared_loop_closures_with(neighbor_id):
            fid = m.p1 if m.r1 == neighbor_id else m.p2
            pid = PoseID(neighbor_id, fid)
            if pid in pose_dict:
                R, t = self.compute_neighbor_transform(m, pose_dict[pid])
                R_vec.append(R)
                t_vec.append(t)
        if not R_vec:
            return None
        max_rotation_error = angular_to_chordal_so3(0.5)  # ~30 degrees
        R_opt, inliers = averaging.robust_single_rotation_averaging(
            R_vec, error_threshold=max_rotation_error
        )
        if self.params.verbose:
            log.info(
                "Robot %d attempts initialization from neighbor %d: "
                "finds %d/%d inliers.",
                self.id, neighbor_id, len(inliers), len(R_vec),
            )
        if len(inliers) < self.params.robust_init_min_inliers:
            return None
        t_opt = averaging.single_translation_averaging([t_vec[i] for i in inliers])
        return np.hstack([R_opt, t_opt[:, None]])

    # ------------------------------------------------------------------
    # Status / termination (reference: PGOAgent.cpp:846-878)
    # ------------------------------------------------------------------

    def set_neighbor_status(self, status: PGOAgentStatus) -> None:
        self.team_status[status.agent_id] = dataclasses.replace(status)

    def has_neighbor_status(self, neighbor_id: int) -> bool:
        return neighbor_id in self.team_status

    def get_neighbor_status(self, neighbor_id: int) -> PGOAgentStatus:
        return self.team_status[neighbor_id]

    def has_neighbor(self, neighbor_id: int) -> bool:
        return self.pose_graph.has_neighbor(neighbor_id)

    def get_neighbors(self) -> List[int]:
        return self.pose_graph.neighbor_ids()

    def is_robot_initialized(self, robot_id: int) -> bool:
        if robot_id == self.id:
            return self.state == PGOAgentState.INITIALIZED
        if not self.has_neighbor_status(robot_id):
            return False
        return self.get_neighbor_status(robot_id).state == PGOAgentState.INITIALIZED

    def is_robot_active(self, robot_id: int) -> bool:
        if robot_id >= self.params.num_robots:
            return False
        return self.team_robot_active[robot_id]

    def set_robot_active(self, robot_id: int, active: bool = True) -> None:
        if robot_id >= self.params.num_robots:
            return
        self.team_robot_active[robot_id] = active
        if self.pose_graph.has_neighbor(robot_id):
            self.pose_graph.set_neighbor_active(robot_id, active)

    def num_active_robots(self) -> int:
        return sum(
            1
            for rid in range(self.params.num_robots)
            if self.is_robot_active(rid)
        )

    def should_terminate(self) -> bool:
        if self.iteration_number >= self.params.max_num_iters:
            return True
        if self.params.robust_cost_params.cost_type != RobustCostType.L2:
            if self.weight_update_count < self.params.robust_opt_num_weight_updates:
                return False
        for rid in range(self.params.num_robots):
            if not self.is_robot_active(rid):
                continue
            if rid not in self.team_status:
                return False
            st = self.team_status[rid]
            if st.state != PGOAgentState.INITIALIZED:
                return False
            if not st.ready_to_terminate:
                return False
        return True

    # ------------------------------------------------------------------
    # GNC weight updates (reference: PGOAgent.cpp:997-1142)
    # ------------------------------------------------------------------

    def initialize_robust_optimization(self) -> None:
        self.robust_cost.reset()
        with self._lock:
            for m in self.pose_graph.active_loop_closures():
                if not m.fixed_weight:
                    m.weight = 1.0

    def should_update_measurement_weights(self) -> bool:
        if self.params.robust_cost_params.cost_type == RobustCostType.L2:
            return False
        if self.weight_update_count >= self.params.robust_opt_num_weight_updates:
            return False
        if self.robust_opt_inner_iter >= self.params.robust_opt_inner_iters:
            return True
        # Only update if all active agents sufficiently converged
        for rid in range(self.params.num_robots):
            if not self.is_robot_active(rid):
                continue
            if rid not in self.team_status:
                return False
            st = self.team_status[rid]
            if st.iteration_number < self.latest_weight_update_iteration:
                return False
            if st.state != PGOAgentState.INITIALIZED:
                return False
            if not st.ready_to_terminate:
                return False
        return True

    def compute_measurement_residual(
        self, m: RelativeSEMeasurement
    ) -> Optional[float]:
        """Residual in the lifted space (reference: PGOAgent.cpp:1062-1102)."""
        if self.state != PGOAgentState.INITIALIZED:
            return None
        d = self.d
        if m.r1 == m.r2:
            Y1, p1 = self.X[m.p1, :, :d], self.X[m.p1, :, d]
            Y2, p2 = self.X[m.p2, :, :d], self.X[m.p2, :, d]
        elif m.r1 == self.id:
            Y1, p1 = self.X[m.p1, :, :d], self.X[m.p1, :, d]
            pid = PoseID(m.r2, m.p2)
            if pid not in self.neighbor_pose_dict:
                return None
            nbr = self.neighbor_pose_dict[pid]
            Y2, p2 = nbr[:, :d], nbr[:, d]
        else:
            Y2, p2 = self.X[m.p2, :, :d], self.X[m.p2, :, d]
            pid = PoseID(m.r1, m.p1)
            if pid not in self.neighbor_pose_dict:
                return None
            nbr = self.neighbor_pose_dict[pid]
            Y1, p1 = nbr[:, :d], nbr[:, d]
        return math.sqrt(measurement_error(m, Y1, p1, Y2, p2))

    def update_measurement_weights(self) -> None:
        if self.state != PGOAgentState.INITIALIZED:
            return
        with self._lock:
            for m in self.pose_graph.active_loop_closures():
                if m.fixed_weight:
                    continue
                residual = self.compute_measurement_residual(m)
                if residual is not None:
                    m.weight = self.robust_cost.weight(residual)
            self.weight_update_count += 1
            self.latest_weight_update_iteration = self.iteration_number
            self.robust_opt_inner_iter = 0
            self.robust_cost.update()
            self.team_status = {}
            self.status.ready_to_terminate = False
            self.status.relative_change = 0.0

            if self.trajectory_reset_count < self.params.robust_opt_num_resets:
                self.trajectory_reset_count += 1
                self.set_X_to_initial_guess()
                self.clear_neighbor_poses()
            if self.params.acceleration:
                self.initialize_acceleration()

    # ------------------------------------------------------------------
    # Rounding / output (reference: PGOAgent.cpp:718-810)
    # ------------------------------------------------------------------

    def get_trajectory_in_local_frame(self) -> Optional[np.ndarray]:
        if self.state != PGOAgentState.INITIALIZED:
            return None
        with self._lock:
            X = jnp.asarray(self.X)
            Y0 = X[0, :, : self.d]  # (r, d)
            T = jnp.einsum("dr,nre->nde", Y0.T, X)
            R = lifted.project_rotation(T[:, :, : self.d])
            t = T[:, :, self.d] - T[0, :, self.d]
            return np.asarray(jnp.concatenate([R, t[:, :, None]], axis=-1))

    def get_trajectory_in_global_frame(self) -> Optional[np.ndarray]:
        if self.global_anchor is None or self.state != PGOAgentState.INITIALIZED:
            return None
        with self._lock:
            Xa = self.global_anchor
            Ya, pa = Xa[:, : self.d], Xa[:, self.d]
            X = jnp.asarray(self.X)
            T = jnp.einsum("dr,nre->nde", jnp.asarray(Ya.T), X)
            R = lifted.project_rotation(T[:, :, : self.d])
            t = T[:, :, self.d] - jnp.asarray(Ya.T @ pa)
            return np.asarray(jnp.concatenate([R, t[:, :, None]], axis=-1))

    def get_pose_in_global_frame(self, pose_id: int) -> Optional[np.ndarray]:
        if self.global_anchor is None or self.state != PGOAgentState.INITIALIZED:
            return None
        if pose_id < 0 or pose_id >= self.num_poses():
            return None
        Xa = self.global_anchor
        Ya, pa = Xa[:, : self.d], Xa[:, self.d]
        Ti = Ya.T @ self.X[pose_id]
        Ti[:, self.d] -= Ya.T @ pa
        return Ti

    def get_neighbor_pose_in_global_frame(
        self, neighbor_id: int, pose_id: int
    ) -> Optional[np.ndarray]:
        if self.global_anchor is None or self.state != PGOAgentState.INITIALIZED:
            return None
        pid = PoseID(neighbor_id, pose_id)
        if pid not in self.neighbor_pose_dict:
            return None
        Xa = self.global_anchor
        Ya, pa = Xa[:, : self.d], Xa[:, self.d]
        Ti = Ya.T @ self.neighbor_pose_dict[pid]
        Ti[:, self.d] -= Ya.T @ pa
        return Ti

    def local_pose_graph_optimization(self) -> np.ndarray:
        """Centralized PGO over the local (private) measurements
        (reference: PGOAgent.cpp:823-828)."""
        T, _ = pgo_mod.solve_pgo(
            self.pose_graph.local_measurements(), ROptParameters()
        )
        return T

    def anchor_first_pose(self, prior: Optional[np.ndarray] = None) -> bool:
        """(reference: PGOAgent.cpp:1196-1212)."""
        if prior is not None:
            assert prior.shape == (self.r, self.d + 1)
            self.pose_graph.set_prior(0, prior)
            return True
        if self.num_poses() > 0:
            self.pose_graph.set_prior(0, self.X[0])
            return True
        return False

    # ------------------------------------------------------------------
    # Reset / lifecycle (reference: PGOAgent.cpp:434-473)
    # ------------------------------------------------------------------

    def reset(self) -> None:
        self.end_optimization_loop()
        if self.params.log_data:
            self.logger.log_measurements(
                self.pose_graph.measurements(), "measurements.csv"
            )
            T = self.get_trajectory_in_global_frame()
            if T is not None:
                self.logger.log_trajectory(
                    self.d, self.num_poses(), T, "trajectory_optimized.csv"
                )
            # pre-rounding lifted solution (reference: PGOAgent.cpp:450-451)
            if self.X is not None:
                from dpgo_tpu.utils import write_matrix_to_file

                write_matrix_to_file(
                    np.asarray(lifted.to_flat(jnp.asarray(self.X))),
                    os.path.join(self.params.log_directory, "X.txt")
                    if self.params.log_directory
                    else "X.txt",
                )
        self.instance_number += 1
        self.iteration_number = 0
        self.latest_weight_update_iteration = 0
        self.robust_opt_inner_iter = 0
        self.weight_update_count = 0
        self.trajectory_reset_count = 0
        self.state = PGOAgentState.WAIT_FOR_DATA
        self.status = PGOAgentStatus(
            self.id, self.state, self.instance_number, 0, False, 0.0
        )
        self.team_status = {}
        self.team_robot_active = [False] * self.params.num_robots
        self.global_anchor = None
        self.T_local_init = None
        self.X_init = None
        self.publish_public_poses_requested = False
        self.publish_asynchronous_requested = False
        self.pose_graph.reset()
        self.clear_neighbor_poses()

    # ------------------------------------------------------------------
    # Asynchronous mode (reference: PGOAgent.cpp:475-513)
    # ------------------------------------------------------------------

    def start_optimization_loop(self) -> None:
        assert not self.params.acceleration, (
            "Asynchronous mode does not support acceleration!"
        )
        with self._thread_lock:
            if self._opt_thread is not None:
                if self._opt_thread.is_alive():
                    return
                self._opt_thread.join()  # reap a finished/dead thread
            self._end_loop_requested = False
            thread = threading.Thread(
                target=self._run_optimization_loop, daemon=True
            )
            # assign + start under the lock: no observer can ever see an
            # assigned-but-unstarted thread (joining one raises RuntimeError)
            self._opt_thread = thread
            thread.start()

    def _run_optimization_loop(self) -> None:
        rate = self.params.asynchronous_rate
        while True:
            self.iterate(True)
            time.sleep(self._rng.exponential(1.0 / rate))
            if self._end_loop_requested:
                break

    def end_optimization_loop(self) -> None:
        with self._thread_lock:
            thread = self._opt_thread
            if thread is None:
                return
            self._end_loop_requested = True
            thread.join()
            self._opt_thread = None
            self._end_loop_requested = False

    def is_optimization_running(self) -> bool:
        with self._thread_lock:
            return self._opt_thread is not None and self._opt_thread.is_alive()

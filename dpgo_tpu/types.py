"""Core types and parameter structs.

Counterparts of the reference's parameter/ID types
(reference: include/DPGO/DPGO_types.h, include/DPGO/PGOAgent.h:47-240,
include/DPGO/DPGO_robust.h:20-77). These are *host-side* (static) dataclasses:
they configure jitted programs and are hashable so they can be passed as static
arguments.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple


class ROptMethod(enum.Enum):
    """Local Riemannian solver (reference: DPGO_types.h:47-52)."""

    RTR = "RTR"
    RGD = "RGD"


class InitializationMethod(enum.Enum):
    """Local trajectory initialization (reference: DPGO_types.h:33-37)."""

    Odometry = "Odometry"
    Chordal = "Chordal"
    GNC_TLS = "GNC_TLS"


class RobustCostType(enum.Enum):
    """Robust cost kernels (reference: DPGO_robust.h:24-31)."""

    L2 = "L2"
    L1 = "L1"
    TLS = "TLS"
    Huber = "Huber"
    GM = "GM"
    GNC_TLS = "GNC_TLS"


class PGOAgentState(enum.Enum):
    """Agent protocol state machine (reference: PGOAgent.h:185-193)."""

    WAIT_FOR_DATA = 0
    WAIT_FOR_INITIALIZATION = 1
    INITIALIZED = 2


@dataclasses.dataclass(frozen=True)
class ROptParameters:
    """Riemannian optimization settings (reference: DPGO_types.h:44-86).

    Defaults match the reference exactly: per-RBCD-step RTR budget of 3 outer
    iterations / 50 tCG inner iterations, |grad| tolerance 1e-2, initial
    trust-region radius 100.
    """

    method: ROptMethod = ROptMethod.RTR
    verbose: bool = False
    gradnorm_tol: float = 1e-2
    RGD_stepsize: float = 1e-3
    RGD_use_preconditioner: bool = True
    RTR_iterations: int = 3
    RTR_tCG_iterations: int = 50
    RTR_initial_radius: float = 100.0


@dataclasses.dataclass(frozen=True)
class RobustCostParameters:
    """Robust cost parameters (reference: DPGO_robust.h:20-77).

    GNC defaults match the reference: maxIters=20, barc=5.0, muStep=1.4,
    initMu=1e-4.
    """

    cost_type: RobustCostType = RobustCostType.L2
    GNC_max_iters: int = 20
    GNC_barc: float = 5.0
    GNC_mu_step: float = 1.4
    GNC_init_mu: float = 1e-4
    huber_threshold: float = 3.0
    TLS_threshold: float = 10.0


@dataclasses.dataclass(frozen=True)
class PGOAgentParameters:
    """Agent parameters (reference: PGOAgent.h:47-179). Defaults mirror the
    reference constructor (PGOAgent.h:113-148)."""

    d: int
    r: int
    num_robots: int = 1
    asynchronous: bool = False
    asynchronous_rate: float = 1.0
    local_opt_params: ROptParameters = dataclasses.field(default_factory=ROptParameters)
    local_initialization_method: InitializationMethod = InitializationMethod.Odometry
    multirobot_initialization: bool = True
    acceleration: bool = False
    restart_interval: int = 30
    robust_cost_params: RobustCostParameters = dataclasses.field(
        default_factory=RobustCostParameters
    )
    robust_opt_num_weight_updates: int = 10
    robust_opt_num_resets: int = 0
    robust_opt_inner_iters: int = 30
    robust_opt_min_convergence_ratio: float = 0.8
    robust_init_min_inliers: int = 2
    max_num_iters: int = 500
    rel_change_tol: float = 5e-3
    verbose: bool = False
    log_data: bool = False
    log_directory: str = ""


@dataclasses.dataclass
class ROPTResult:
    """Local-solve statistics (reference: DPGO_types.h:91-107)."""

    success: bool = False
    fInit: float = 0.0
    gradNormInit: float = 0.0
    fOpt: float = 0.0
    gradNormOpt: float = 0.0
    elapsedMs: float = 0.0


class PoseID(NamedTuple):
    """Unique pose = (robot_id, frame_id) (reference: DPGO_types.h:110-120).

    A NamedTuple: hashable, ordered, usable as a dict key — the reference's
    ComparePoseID ordering is the natural tuple ordering.
    """

    robot_id: int
    frame_id: int


class EdgeID(NamedTuple):
    """Directed measurement edge (reference: DPGO_types.h:131-152)."""

    src: PoseID
    dst: PoseID

    def is_odometry(self) -> bool:
        return (
            self.src.robot_id == self.dst.robot_id
            and self.src.frame_id + 1 == self.dst.frame_id
        )

    def is_private_loop_closure(self) -> bool:
        return (
            self.src.robot_id == self.dst.robot_id
            and self.src.frame_id + 1 != self.dst.frame_id
        )

    def is_shared_loop_closure(self) -> bool:
        return self.src.robot_id != self.dst.robot_id


@dataclasses.dataclass
class PGOAgentStatus:
    """Distributed status/metrics packet (reference: PGOAgent.h:196-240)."""

    agent_id: int = 0
    state: PGOAgentState = PGOAgentState.WAIT_FOR_DATA
    instance_number: int = 0
    iteration_number: int = 0
    ready_to_terminate: bool = False
    relative_change: float = 0.0


@dataclasses.dataclass
class PoseGraphStatistics:
    """Loop-closure accept/reject statistics used to gate GNC termination
    (reference: PoseGraph.h Statistics / PoseGraph.cpp:305-343)."""

    total_loop_closures: float = 0.0
    accept_loop_closures: float = 0.0
    reject_loop_closures: float = 0.0
    undecided_loop_closures: float = 0.0


# Hard-coded constants preserved from the reference (see SURVEY.md §5.6).
PRIOR_KAPPA: float = 1.0e4  # PoseGraph.cpp:17
PRIOR_TAU: float = 1.0e2  # PoseGraph.cpp:18
PRECONDITIONER_SHIFT: float = 1.0e-1  # PoseGraph.cpp:603

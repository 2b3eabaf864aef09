"""dpgo_tpu — distributed certifiably-correct pose-graph optimization in JAX.

A from-scratch JAX/XLA re-design of the capabilities of mit-acl/dpgo
(synchronous + asynchronous Riemannian block-coordinate descent over rank-lifted
SE(d) pose graphs, Nesterov acceleration, chordal/odometry initialization, GNC
outlier-robust optimization, multi-robot protocol semantics).

Design stance (vs. the C++/Eigen/ROPTLIB reference):
  * lifted poses are batched arrays X: (n, r, d+1) — one leading pose axis so every
    manifold op is one batched array op instead of a per-pose loop
    (reference: LiftedSEManifold.cpp:34-45 OpenMP loop).
  * the pose-graph connection Laplacian is never materialized as a scalar sparse
    matrix; it lives as (d+1)x(d+1) block arrays + edge index lists, and the hot
    Hessian-vector product V·Q is a batched small-matmul + segment-sum
    (reference: PoseGraph.cpp:381-491 builds an Eigen::SparseMatrix).
  * ROPTLIB's RTRNewton is replaced by a fully jit'd Riemannian trust region with
    preconditioned truncated CG (solvers/rtr.py), semantics matched to
    QuadraticOptimizer.cpp:50-108.
  * SPQR / Cholmod direct solves are replaced by iterative (CG) solves and a
    batched block preconditioner (solvers/chordal.py, quadratic.py).
  * multi-robot message passing lowers to collectives over an "agents" mesh axis
    (parallel/), instead of caller-provided PoseDict exchange.
"""

import os

# Certifiable PGO parity targets (1e-6 vs the f64 C++ reference) require double
# precision; enable x64 before any jax array is created. Opt out with
# DPGO_TPU_X64=0 for f32-only experiments.
if os.environ.get("DPGO_TPU_X64", "1") != "0":
    import jax

    jax.config.update("jax_enable_x64", True)


from dpgo_tpu.types import (  # noqa: E402
    InitializationMethod,
    PGOAgentState,
    PGOAgentStatus,
    PGOAgentParameters,
    ROptMethod,
    ROptParameters,
    ROPTResult,
    RobustCostParameters,
    RobustCostType,
    PoseID,
    EdgeID,
)
from dpgo_tpu.measurements import RelativeSEMeasurement  # noqa: E402
from dpgo_tpu.io.g2o import read_g2o_file  # noqa: E402
from dpgo_tpu.posegraph import PoseGraph  # noqa: E402
from dpgo_tpu.robust import RobustCost  # noqa: E402
from dpgo_tpu.agent import PGOAgent  # noqa: E402
from dpgo_tpu.solvers.pgo import (  # noqa: E402
    chordal_initialization,
    odometry_initialization,
    solve_pgo,
    solve_robust_pgo,
    SolveRobustPGOParams,
)
from dpgo_tpu.ops import lifted  # noqa: E402
from dpgo_tpu.solvers.certify import (  # noqa: E402
    min_eig_certificate,
    solve_pgo_staircase,
)

__all__ = [
    "InitializationMethod",
    "PGOAgent",
    "PGOAgentState",
    "PGOAgentStatus",
    "PGOAgentParameters",
    "PoseGraph",
    "PoseID",
    "EdgeID",
    "ROptMethod",
    "ROptParameters",
    "ROPTResult",
    "RelativeSEMeasurement",
    "RobustCost",
    "RobustCostParameters",
    "RobustCostType",
    "SolveRobustPGOParams",
    "chordal_initialization",
    "lifted",
    "min_eig_certificate",
    "odometry_initialization",
    "solve_pgo_staircase",
    "read_g2o_file",
    "solve_pgo",
    "solve_robust_pgo",
]

__version__ = "0.1.0"

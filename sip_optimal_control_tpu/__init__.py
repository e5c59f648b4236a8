"""sip_optimal_control_tpu — a batched trajectory-optimization engine.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of the
C++ reference `joaospinto/sip_optimal_control`: a stagewise interior-point
NLP solver whose Newton-KKT systems are reduced to dual-regularized LQR over
rooted trees and solved by Riccati recursions — plus additions the
reference doesn't have: scenario batching via vmap, multi-host scenario
sharding via jax.sharding, level-synchronous tree recursion, and
associative-scan parallel-in-time Riccati.
"""

from .types import (Dimensions, DimensionError, FactorStatus,
                    InputValidationStatus, Topology, TopologyError,
                    TopologySchedule, compile_topology, try_compile_topology,
                    validate_input)
from .ops.lqr import (LQRData, LQRFactorization, LQRSolution, lqr_factor,
                      lqr_factor_solve, lqr_residual_norm, lqr_solve,
                      pad_lqr_data)
from .solver import (OCProblem, Primal, Settings, SIPStatus, SolveResult,
                     YVec, ZVec, solve)
from .model import ModelSpec, box_bounds, build_problem
from .mpc import MPCTrace, run_mpc, run_mpc_timed
from .parallel import scenario_mesh, shard_scenarios, solve_batch_sharded

__version__ = "0.1.0"

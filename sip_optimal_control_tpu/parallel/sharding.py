"""Multi-device scenario sharding (BASELINE config 5).

The reference is single-threaded C++ with no distribution (SURVEY 2.10).
Here scenarios are data-parallel across a `jax.sharding.Mesh` axis via
`shard_map`, each device vmapping its local shard of interior-point
solves, with XLA collectives (`psum`) only for cross-scenario aggregates.
Multi-host runs use the same code over all devices after
`jax.distributed.initialize`; XLA routes the collectives.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..model import ModelSpec, build_problem
from ..solver.settings import Settings
from ..solver.sip import solve
from ..types import Dimensions, Topology


class BatchSolveStats(NamedTuple):
    """Cross-scenario aggregates computed with collectives."""

    total_solved: jax.Array
    max_kkt_error: jax.Array
    mean_iterations: jax.Array


def scenario_mesh(devices: Optional[Sequence] = None,
                  axis_name: str = "scenario") -> Mesh:
    devices = jax.devices() if devices is None else list(devices)
    return Mesh(np.asarray(devices), (axis_name,))


def shard_scenarios(arr: jax.Array, mesh: Mesh,
                    axis_name: str = "scenario") -> jax.Array:
    """Place a [B, ...] batch with B sharded over the mesh axis."""
    return jax.device_put(arr, NamedSharding(mesh, P(axis_name)))


def solve_batch_sharded(spec: ModelSpec, dims: Dimensions,
                        topology: Topology, x0s: jax.Array,
                        settings: Optional[Settings] = None,
                        mesh: Optional[Mesh] = None,
                        axis_name: str = "scenario", lower=None, upper=None,
                        init_vars=None, init_y=None):
    """Solve a batch of scenarios sharded across devices.

    Returns (controls [B, E, m], statuses [B], stats) where `stats` holds
    psum/pmean cross-scenario reductions — the collective pattern that
    robust-MPC couplings and global metrics ride on.

    ``init_vars`` / ``init_y``: optional batched warm start (leaves with a
    leading [B] axis, e.g. the ``vars`` / ``y`` of a previous vmapped
    ``solve``), sharded like ``x0s``.

    With ``Settings.riccati_backend="pallas"`` the shard_map runs with
    ``check_vma=False``: the Pallas Riccati kernels carry no varying-axes
    types.  Every other backend keeps the check."""
    settings = settings or Settings()
    mesh = mesh or scenario_mesh(axis_name=axis_name)

    def solve_one(x0, warm):
        problem = build_problem(spec, dims, topology, initial_state=x0,
                                lower=lower, upper=upper)
        return solve(problem, settings, *warm)

    def shard_fn(x0_local, warm_local):
        res = jax.vmap(solve_one)(x0_local, warm_local)
        solved = jnp.sum((res.status == 0).astype(jnp.int32))
        stats = BatchSolveStats(
            total_solved=jax.lax.psum(solved, axis_name),
            max_kkt_error=jax.lax.pmax(jnp.max(res.kkt_error), axis_name),
            mean_iterations=jax.lax.pmean(
                jnp.mean(res.iterations.astype(jnp.float32)), axis_name))
        return res.vars.u, res.status, stats

    fn = shard_map(
        shard_fn, mesh=mesh, in_specs=(P(axis_name), P(axis_name)),
        out_specs=(P(axis_name), P(axis_name), P()),
        check_vma=settings.riccati_backend != "pallas")
    return fn(x0s, (init_vars, init_y))


def solve_joint_theta(spec: ModelSpec, dims: Dimensions,
                      topology: Topology, x0s: jax.Array,
                      settings: Optional[Settings] = None,
                      mesh: Optional[Mesh] = None,
                      axis_name: str = "scenario",
                      lower=None, upper=None,
                      hessian_mode: str = "exact",
                      scale_dual=1.0, scale_equality=1.0, scale_bound=1.0):
    """Jointly solve S scenarios that share ONE global theta, with the
    scenarios sharded across the mesh (SURVEY 2.10(c): coupled cross-shard
    computation, not just data-parallel metrics).

    Each scenario is a copy of the stagewise problem with its own initial
    state ``x0s[s]`` but a single shared parameter vector theta: the joint
    NLP is  min_{v_1..v_S, theta} sum_s f(v_s, theta)  s.t. per-scenario
    constraints.  Mathematically this equals one star tree (a
    zero-state-dim root fanning out to the S scenario chains) solved on
    one device — the structure the reference's theta/Schur path expresses
    serially (reference: helpers.cpp:376-407) — but here the scenario
    blocks factor shard-locally and ONLY the p x p theta Schur complement
    and theta RHS cross device boundaries, as psums over ICI.

    Returns the vmapped SolveResult over all S scenarios; theta is
    replicated (identical on every scenario lane) — read
    ``result.vars.theta[0]``.

    Requires unbounded theta (see solver.sip.solve's coupled_axes doc).
    ``mesh=None`` runs the same coupled solve on one device (vmap only) —
    the oracle the sharded run is tested against."""
    settings = settings or Settings()
    local_axis = "joint_theta_local"

    def solve_one(x0, axes):
        problem = build_problem(spec, dims, topology, initial_state=x0,
                                lower=lower, upper=upper,
                                hessian_mode=hessian_mode,
                                scale_dual=scale_dual,
                                scale_equality=scale_equality,
                                scale_bound=scale_bound)
        return solve(problem, settings, coupled_axes=axes)

    if mesh is None:
        return jax.vmap(lambda x0: solve_one(x0, (local_axis,)),
                        axis_name=local_axis)(x0s)

    def shard_fn(x0_local):
        return jax.vmap(lambda x0: solve_one(x0, (local_axis, axis_name)),
                        axis_name=local_axis)(x0_local)

    # check_vma=False: jax 0.7's varying-axes checker cannot yet express
    # collectives over a vmap axis nested inside shard_map (psum over the
    # local scenario lanes); the collectives themselves compile and run
    # correctly (see tests/test_joint_theta.py's single-device parity).
    fn = shard_map(shard_fn, mesh=mesh, in_specs=(P(axis_name),),
                   out_specs=P(axis_name), check_vma=False)
    return fn(x0s)

"""Coupled shared-theta solve tests (SURVEY 2.10(c)).

`solve_joint_theta` solves S scenarios sharing ONE global theta, with the
theta Schur complement / RHS psum-reduced across the scenario axes
(vmap lanes and mesh shards).  The mathematical oracle is the equivalent
star tree — a zero-state-dim root fanning out to the S scenario chains —
solved as a single problem by the ordinary solver (whose theta path is
itself parity-tested against the dense KKT oracle in test_kkt.py).  The
sharded run is then checked against the single-device coupled run in an
8-virtual-device subprocess.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp

from sip_optimal_control_tpu import (Dimensions, ModelSpec, Settings,
                                     Topology, box_bounds, build_problem)
from sip_optimal_control_tpu.parallel import solve_joint_theta
from sip_optimal_control_tpu.solver.sip import solve

DT = 0.2
T_H = 4          # horizon (edges per scenario chain)
N_X, N_U = 2, 1


def _chain_dynamics(x, u, th, i):
    # double integrator; theta does not enter the dynamics
    return jnp.stack([x[0] + DT * x[1], x[1] + DT * u[0]])


def _node_cost(x, th, i):
    # pulls every position toward the SHARED setpoint theta -> the joint
    # optimum balances theta across all scenarios
    return 0.5 * (x[0] - th[0]) ** 2 + 0.05 * x[1] ** 2


def _edge_cost(x, u, th, i):
    return 0.05 * u[0] ** 2


def _joint_pieces():
    spec = ModelSpec(dynamics=_chain_dynamics, node_cost=_node_cost,
                     edge_cost=_edge_cost)
    dims = Dimensions.uniform(num_edges=T_H, state_dim=N_X,
                              control_dim=N_U, theta_dim=1)
    topo = Topology.chain(T_H)
    lower, upper = box_bounds(dims, u_lower=-1.0, u_upper=1.0)
    return spec, dims, topo, lower, upper


def _star_tree_problem(x0s):
    """The S scenario chains as ONE problem: a 0-state root node with S
    edges (control dim 0) whose 'dynamics' pin each chain root to its
    scenario's initial state, then ordinary chain edges."""
    S = x0s.shape[0]
    edge_parents, edge_children = [], []
    state_dims, control_dims = [0], []
    is_root_edge, edge_x0 = [], []
    nxt = 1
    for s in range(S):
        # root edge: root -> chain node 0 of scenario s
        edge_parents.append(0)
        edge_children.append(nxt)
        control_dims.append(0)
        is_root_edge.append(True)
        edge_x0.append(np.asarray(x0s[s]))
        state_dims.append(N_X)
        prev = nxt
        nxt += 1
        for _ in range(T_H):
            edge_parents.append(prev)
            edge_children.append(nxt)
            control_dims.append(N_U)
            is_root_edge.append(False)
            edge_x0.append(np.zeros(N_X))
            state_dims.append(N_X)
            prev = nxt
            nxt += 1
    N, E = nxt, len(edge_parents)
    topo = Topology.tree(0, edge_parents, edge_children)
    dims = Dimensions(theta_dim=1, state_dims=tuple(state_dims),
                      control_dims=tuple(control_dims),
                      node_c_dims=(0,) * N, node_g_dims=(0,) * N,
                      edge_c_dims=(0,) * E, edge_g_dims=(0,) * E)
    root_flag = jnp.asarray(np.asarray(is_root_edge))
    x0_table = jnp.asarray(np.stack(edge_x0))
    is_root_node = jnp.asarray(np.arange(N) == 0)

    def dynamics(x, u, th, i):
        # root edges ignore the (0-dim, zero-padded) parent state and
        # emit the scenario's initial state; chain edges integrate
        return jnp.where(root_flag[i], x0_table[i],
                         _chain_dynamics(x, u, th, i))

    def node_cost(x, th, i):
        return jnp.where(is_root_node[i], 0.0, _node_cost(x, th, i))

    def edge_cost(x, u, th, i):
        return jnp.where(root_flag[i], 0.0, _edge_cost(x, u, th, i))

    spec = ModelSpec(dynamics=dynamics, node_cost=node_cost,
                     edge_cost=edge_cost)
    lower, upper = box_bounds(dims, u_lower=-1.0, u_upper=1.0)
    return spec, dims, topo, lower, upper


def test_coupled_vmap_matches_star_tree():
    """Single-device coupled solve (vmap lanes + psum couplings) ==
    the equivalent star-tree problem solved as one NLP."""
    S = 3
    rng = np.random.default_rng(0)
    x0s = jnp.asarray(rng.standard_normal((S, N_X)))
    settings = Settings(max_iterations=60, tol=1e-10)

    spec, dims, topo, lower, upper = _joint_pieces()
    res = jax.jit(lambda b: solve_joint_theta(
        spec, dims, topo, b, settings=settings, lower=lower,
        upper=upper))(x0s)
    assert np.all(np.asarray(res.status) == 0), np.asarray(res.status)
    # theta replicated bit-identically across scenario lanes
    th = np.asarray(res.vars.theta)
    assert np.all(th == th[0]), th

    # star-tree oracle
    sspec, sdims, stopo, slo, sup = _star_tree_problem(np.asarray(x0s))
    problem = build_problem(sspec, sdims, stopo,
                            initial_state=jnp.zeros((0,)), lower=slo,
                            upper=sup)
    sres = jax.jit(lambda: solve(problem, settings))()
    assert int(sres.status) == 0

    np.testing.assert_allclose(th[0], np.asarray(sres.vars.theta),
                               atol=1e-6)
    # controls: scenario s's chain edges are star edges s*(T+1)+1 .. +T
    u_star = np.asarray(sres.vars.u)
    for s in range(S):
        mine = np.asarray(res.vars.u[s])[:, 0]
        ref = u_star[s * (T_H + 1) + 1: s * (T_H + 1) + 1 + T_H, 0]
        np.testing.assert_allclose(mine, ref, atol=1e-6)
    # the shared theta really is a compromise: it differs from what any
    # single scenario alone would choose
    one = jax.jit(lambda x0: solve(build_problem(
        spec, dims, topo, initial_state=x0, lower=lower, upper=upper),
        settings).vars.theta)(x0s[0])
    assert abs(float(one[0]) - th[0, 0]) > 1e-4


def test_coupled_requires_unbounded_theta():
    spec, dims, topo, _, _ = _joint_pieces()
    lower, upper = box_bounds(dims, u_lower=-1.0, u_upper=1.0,
                              theta_lower=-2.0, theta_upper=2.0)
    x0s = jnp.zeros((2, N_X))
    try:
        solve_joint_theta(spec, dims, topo, x0s,
                          settings=Settings(max_iterations=3),
                          lower=lower, upper=upper)
    except ValueError as e:
        assert "unbounded theta" in str(e)
    else:
        raise AssertionError("theta bounds must be rejected")


_SHARDED_SCRIPT = r"""
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np, jax.numpy as jnp
from sip_optimal_control_tpu import Settings
from sip_optimal_control_tpu.parallel import scenario_mesh, shard_scenarios, \
    solve_joint_theta
from tests.test_joint_theta import _joint_pieces, N_X

assert jax.device_count() == 8, jax.devices()
spec, dims, topo, lower, upper = _joint_pieces()
settings = Settings(max_iterations=60, tol=1e-10)
rng = np.random.default_rng(1)
x0s = jnp.asarray(rng.standard_normal((16, N_X)))

mesh = scenario_mesh()
res_sh = jax.jit(lambda b: solve_joint_theta(
    spec, dims, topo, b, settings=settings, mesh=mesh, lower=lower,
    upper=upper))(shard_scenarios(x0s, mesh))
res_1d = jax.jit(lambda b: solve_joint_theta(
    spec, dims, topo, b, settings=settings, lower=lower,
    upper=upper))(x0s)

assert np.all(np.asarray(res_sh.status) == 0)
th_sh = np.asarray(res_sh.vars.theta)
assert np.all(th_sh == th_sh[0]), "theta must be replicated across shards"
np.testing.assert_allclose(th_sh, np.asarray(res_1d.vars.theta),
                           atol=1e-10)
np.testing.assert_allclose(np.asarray(res_sh.vars.u),
                           np.asarray(res_1d.vars.u), atol=1e-10)
np.testing.assert_allclose(np.asarray(res_sh.vars.x),
                           np.asarray(res_1d.vars.x), atol=1e-10)
print("JOINT-THETA-SHARDED-OK")
"""


def test_sharded_joint_theta_matches_single_device():
    """8-virtual-device shard_map coupled solve == vmap-only coupled
    solve (the cross-shard psums must reproduce the single-device sums)."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_COMPILATION_CACHE_DIR"] = os.path.join(repo, ".jax_cache")
    env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "0.3"
    result = subprocess.run([sys.executable, "-c", _SHARDED_SCRIPT],
                            capture_output=True, text=True, timeout=900,
                            env=env, cwd=repo)
    assert result.returncode == 0, result.stderr[-3000:]
    assert "JOINT-THETA-SHARDED-OK" in result.stdout

"""Robust MPC over a scenario tree, batched and sharded across devices
(BASELINE config 5).

Each solve optimizes a control policy over a disturbance tree: a shared
first stage, then branches with different wind drifts — the control at the
shared stage must hedge across futures (the tree-LQR machinery the
reference benchmarks as shallow_wide/binary trees,
reference: benchmarks/lqr_benchmark.cpp:209-271, done here through the full
IPM).  A batch of initial states is sharded over the device mesh with
shard_map; cross-scenario stats ride psum.

Run (8 simulated devices on CPU):
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python examples/robust_mpc_sharded.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import jax
import jax.numpy as jnp

import sip_optimal_control_tpu as soc
from sip_optimal_control_tpu.parallel import (scenario_mesh, shard_scenarios,
                                              solve_batch_sharded)


def wind_tree(shared=2, branch_len=4, winds=(-0.3, 0.0, 0.3), dt=0.1):
    """Chain of `shared` stages, then one branch per wind hypothesis."""
    parents, children, drift = [], [], []
    node = 1
    prev_shared = 0
    for _ in range(shared):
        parents.append(prev_shared)
        children.append(node)
        drift.append(0.0)
        prev_shared = node
        node += 1
    for w in winds:
        prev = prev_shared
        for _ in range(branch_len):
            parents.append(prev)
            children.append(node)
            drift.append(w)
            prev = node
            node += 1
    E = len(parents)
    drift_arr = jnp.asarray(drift)
    A = jnp.asarray([[1.0, dt], [0.0, 1.0]])
    B = jnp.asarray([[0.0], [dt]])

    def dynamics(x, u, th, i):
        return A @ x + B @ u + drift_arr[i] * dt * jnp.asarray([1.0, 0.0])

    spec = soc.ModelSpec(
        dynamics=dynamics,
        node_cost=lambda x, th, i: 0.5 * jnp.sum(x ** 2),
        edge_cost=lambda x, u, th, i: 0.5 * 0.05 * jnp.sum(u ** 2),
    )
    topo = soc.Topology.tree(0, parents, children)
    dims = soc.Dimensions.uniform(num_edges=E, state_dim=2, control_dim=1)
    return spec, dims, topo


def main():
    spec, dims, topo = wind_tree()
    mesh = scenario_mesh()
    n_dev = len(jax.devices())
    B = 4 * n_dev

    rng = np.random.default_rng(0)
    x0s = jnp.asarray(
        np.stack([np.array([1.0, 0.0]) + 0.2 * rng.standard_normal(2)
                  for _ in range(B)]).astype(jnp.result_type(float)))
    x0s = shard_scenarios(x0s, mesh)

    lower, upper = soc.box_bounds(dims, u_lower=-2.0, u_upper=2.0)
    f64 = jnp.result_type(float) == jnp.float64
    settings = (soc.Settings(max_iterations=60, tol=1e-6) if f64 else
                soc.Settings(max_iterations=60, tol=1e-3, mu_min=1e-5,
                             reg_floor=1e-5, prox_reg=1e-5))
    u, statuses, stats = jax.jit(
        lambda b: solve_batch_sharded(spec, dims, topo, b,
                                      settings=settings, mesh=mesh,
                                      lower=lower, upper=upper))(x0s)
    jax.block_until_ready(u)
    print(f"devices: {n_dev}, scenarios: {B} (sharded over mesh "
          f"'{list(mesh.axis_names)[0]}')")
    print(f"solved {int(stats.total_solved)}/{B}, "
          f"mean iterations {float(stats.mean_iterations):.1f}, "
          f"max kkt {float(stats.max_kkt_error):.2e}")
    # the shared-stage control hedges across the wind branches
    print(f"first-stage control, scenario 0: {float(u[0, 0, 0]):+.4f}")


if __name__ == "__main__":
    main()

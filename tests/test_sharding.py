"""Multi-device sharding tests.

Run in a subprocess with 8 virtual CPU devices: setting
--xla_force_host_platform_device_count in the main test process would slow
every XLA:CPU compile ~7x (see conftest.py), and env must be set before jax
import."""

import os
import subprocess
import sys

_SCRIPT = r"""
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from sip_optimal_control_tpu import Settings
from sip_optimal_control_tpu.models import double_integrator
from sip_optimal_control_tpu.parallel import (scenario_mesh, shard_scenarios,
                                              solve_batch_sharded)
from sip_optimal_control_tpu.model import build_problem
from sip_optimal_control_tpu.solver.sip import solve

assert jax.device_count() == 8, jax.devices()
spec, dims, topo = double_integrator(horizon=10)
mesh = scenario_mesh()
settings = Settings(max_iterations=30, tol=1e-8)

rng = np.random.default_rng(0)
x0s = jnp.asarray(rng.standard_normal((16, 2)))
x0s_sharded = shard_scenarios(x0s, mesh)
u, statuses, stats = jax.jit(lambda b: solve_batch_sharded(
    spec, dims, topo, b, settings=settings, mesh=mesh))(x0s_sharded)
assert np.all(np.asarray(statuses) == 0), np.asarray(statuses)
assert int(stats.total_solved) == 16

# sharded result == single-device vmap result
def one(x0):
    problem = build_problem(spec, dims, topo, initial_state=x0)
    return solve(problem, settings).vars.u
u_ref = jax.jit(jax.vmap(one))(x0s)
np.testing.assert_allclose(np.asarray(u), np.asarray(u_ref), atol=1e-10)
print("SHARDING_OK")
"""

_WARM_SCRIPT = r"""
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from sip_optimal_control_tpu import Settings
from sip_optimal_control_tpu.models import double_integrator
from sip_optimal_control_tpu.parallel import (scenario_mesh, shard_scenarios,
                                              solve_batch_sharded)
from sip_optimal_control_tpu.model import build_problem
from sip_optimal_control_tpu.solver.sip import solve

spec, dims, topo = double_integrator(horizon=10)
mesh = scenario_mesh()
settings = Settings(max_iterations=30, tol=1e-8)

def one(x0, wv, wy):
    problem = build_problem(spec, dims, topo, initial_state=x0)
    res = solve(problem, settings, init_vars=wv, init_y=wy)
    return res.vars, res.y, res.iterations
single = jax.jit(jax.vmap(one))

rng = np.random.default_rng(0)
x0s = jnp.asarray(rng.standard_normal((16, 2)))
cold_vars, cold_y, cold_iters = single(x0s, None, None)
x0w = x0s + 1e-3 * jnp.asarray(rng.standard_normal((16, 2)))
warm_vars, _, warm_iters = single(x0w, cold_vars, cold_y)
assert float(jnp.mean(warm_iters)) < float(jnp.mean(cold_iters))

u, statuses, stats = jax.jit(lambda x, v, y: solve_batch_sharded(
    spec, dims, topo, x, settings=settings, mesh=mesh, init_vars=v,
    init_y=y))(*shard_scenarios((x0w, cold_vars, cold_y), mesh))
assert np.all(np.asarray(statuses) == 0), np.asarray(statuses)
np.testing.assert_allclose(float(stats.mean_iterations),
                           float(jnp.mean(warm_iters)))
np.testing.assert_allclose(np.asarray(u), np.asarray(warm_vars.u),
                           atol=1e-10)
print("WARM_SHARDING_OK")
"""


def _cache_env(env):
    """Point the subprocess at the repo's persistent compile cache: the
    8-virtual-device XLA:CPU compile dominates these tests' wall time and
    is identical across runs (jax honors these env vars natively)."""
    env["JAX_COMPILATION_CACHE_DIR"] = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache")
    env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "0.3"
    return env


def test_sharded_solve_matches_vmap():
    env = _cache_env(dict(os.environ))
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8").strip()
    result = subprocess.run([sys.executable, "-c", _SCRIPT],
                            capture_output=True, text=True, timeout=580,
                            env=env, cwd=os.path.dirname(os.path.dirname(
                                os.path.abspath(__file__))))
    assert "SHARDING_OK" in result.stdout, (result.stdout, result.stderr)


def test_sharded_warm_start_matches_vmap():
    """A sharded warm re-solve (init_vars / init_y sharded with the batch)
    equals the vmapped warm re-solve and takes fewer iterations than the
    cold solve it starts from."""
    env = _cache_env(dict(os.environ))
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8").strip()
    result = subprocess.run([sys.executable, "-c", _WARM_SCRIPT],
                            capture_output=True, text=True, timeout=580,
                            env=env, cwd=os.path.dirname(os.path.dirname(
                                os.path.abspath(__file__))))
    assert "WARM_SHARDING_OK" in result.stdout, (result.stdout,
                                                 result.stderr)


def test_dryrun_multichip_entry():
    env = _cache_env(dict(os.environ))
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8").strip()
    script = ("import jax; jax.config.update('jax_platforms','cpu');"
              "from __graft_entry__ import dryrun_multichip;"
              "dryrun_multichip(8); print('DRYRUN_OK')")
    result = subprocess.run([sys.executable, "-c", script],
                            capture_output=True, text=True, timeout=580,
                            env=env, cwd=os.path.dirname(os.path.dirname(
                                os.path.abspath(__file__))))
    assert "DRYRUN_OK" in result.stdout, (result.stdout, result.stderr)

"""Multi-PROCESS sharding test: the 2-host analog on CPU.

test_sharding.py proves the 8-virtual-device single-process path; this test
goes one step further and runs `solve_batch_sharded` as a true SPMD program
across TWO OS processes (4 virtual CPU devices each) joined by
`jax.distributed.initialize` — the same initialization a multi-host run
uses (SURVEY §2.10(e)), with the coordinator/DCN role played by localhost.
Each process owns only its addressable shards of the global batch; the
cross-scenario stats ride collectives spanning the process boundary.
"""

import os
import socket
import subprocess
import sys

_WORKER = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
proc_id, num_procs, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=num_procs, process_id=proc_id)
jax.config.update("jax_enable_x64", True)

import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from sip_optimal_control_tpu import Settings
from sip_optimal_control_tpu.models import double_integrator
from sip_optimal_control_tpu.model import build_problem
from sip_optimal_control_tpu.parallel import scenario_mesh, solve_batch_sharded
from sip_optimal_control_tpu.solver.sip import solve

assert jax.process_count() == num_procs, jax.process_count()
assert len(jax.local_devices()) == 4, jax.local_devices()
assert jax.device_count() == 8, jax.devices()

spec, dims, topo = double_integrator(horizon=10)
mesh = scenario_mesh()          # all 8 global devices, 2 processes
settings = Settings(max_iterations=30, tol=1e-8)

B = 16
rng = np.random.default_rng(0)  # same seed everywhere: same global batch
x0s_np = rng.standard_normal((B, 2))
sharding = NamedSharding(mesh, P("scenario"))
x0s = jax.make_array_from_callback(
    (B, 2), sharding, lambda idx: x0s_np[idx])

u, statuses, stats = jax.jit(lambda b: solve_batch_sharded(
    spec, dims, topo, b, settings=settings, mesh=mesh))(x0s)
jax.block_until_ready(u)

# stats are replicated (out_specs P()) -> psum crossed the process boundary
assert int(stats.total_solved) == B, int(stats.total_solved)
assert float(stats.max_kkt_error) <= settings.tol

# every locally-owned shard matches an independent single-process solve
def one(x0):
    problem = build_problem(spec, dims, topo, initial_state=x0)
    return solve(problem, settings).vars.u
u_ref = jax.jit(jax.vmap(one))(jnp.asarray(x0s_np))

for shard in statuses.addressable_shards:
    assert np.all(np.asarray(shard.data) == 0), np.asarray(shard.data)
for shard in u.addressable_shards:
    np.testing.assert_allclose(np.asarray(shard.data),
                               np.asarray(u_ref[shard.index]), atol=1e-10)
print(f"MULTIPROC_OK_{proc_id}", flush=True)
"""


def test_two_process_sharded_solve():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=4").strip()
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # persistent compile cache: the 4-virtual-device XLA:CPU compile
    # dominates this test's 85 s wall and is identical across runs
    env["JAX_COMPILATION_CACHE_DIR"] = os.path.join(cwd, ".jax_cache")
    env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "0.3"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(i), "2", port],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=cwd) for i in range(2)]
    outs = []
    try:
        for i, p in enumerate(procs):
            out, err = p.communicate(timeout=560)
            outs.append((out, err))
            assert p.returncode == 0, (i, out, err)
    finally:
        for p in procs:
            p.kill()
    assert "MULTIPROC_OK_0" in outs[0][0], outs[0]
    assert "MULTIPROC_OK_1" in outs[1][0], outs[1]

"""Cartpole swing-up (BASELINE config 3): one solve, then a vmapped batch.

Run: JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 python examples/cartpole_swingup.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import jax
import jax.numpy as jnp

import sip_optimal_control_tpu as soc
from sip_optimal_control_tpu.models import cartpole_swingup


def main():
    spec, dims, topo, lower, upper, x0 = cartpole_swingup(horizon=50)
    f64 = jnp.result_type(float) == jnp.float64
    # fp64 reaches tight tolerances; fp32 (JAX's default) needs barrier and
    # regularization floors above single precision (as bench.py uses)
    settings = (soc.Settings(max_iterations=100, tol=1e-6) if f64 else
                soc.Settings(max_iterations=100, tol=1e-3, mu_min=1e-5,
                             reg_floor=1e-5, prox_reg=1e-5))

    problem = soc.build_problem(spec, dims, topo, initial_state=x0,
                                lower=lower, upper=upper)
    res = jax.jit(lambda: soc.solve(problem, settings))()
    u = np.asarray(res.vars.u)
    xs = np.asarray(res.vars.x)
    print(f"single solve: status={int(res.status)} "
          f"iters={int(res.iterations)} kkt={float(res.kkt_error):.2e}")
    print(f"  final angle {xs[-1, 2]:+.4f} rad (0 = upright), "
          f"|u| range [{u.min():+.2f}, {u.max():+.2f}] (limit 10)")

    # a batch of perturbed starts, one jitted vmap
    B = 64
    rng = np.random.default_rng(0)
    x0s = np.tile(np.asarray(x0), (B, 1))
    x0s[:, 0] += 0.1 * rng.standard_normal(B)
    x0s = jnp.asarray(x0s)

    def solve_one(x0_i):
        p = soc.build_problem(spec, dims, topo, initial_state=x0_i,
                              lower=lower, upper=upper)
        r = soc.solve(p, settings)
        return r.status, r.iterations

    statuses, iters = jax.jit(jax.vmap(solve_one))(x0s)
    print(f"batch of {B}: solved {int(jnp.sum(statuses == 0))}/{B}, "
          f"mean iterations {float(jnp.mean(iters)):.1f}")


if __name__ == "__main__":
    main()

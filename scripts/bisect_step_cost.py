"""Bisect where the warm-MPC iteration time goes on the ambient device.

`tol=0` forces every scenario to run exactly `max_iterations` IPM
iterations (no early exit), so timing a single warm-started batched solve
at several K values gives a clean per-iteration slope and a fixed
per-dispatch intercept, which cancels the fixed cost of a dispatch.  Sweeping hessian mode and line-search depth attributes the slope:

  python scripts/bisect_step_cost.py [--batch 4096] [--horizon 50]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--horizon", type=int, default=50)
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from sip_optimal_control_tpu.utils import enable_compile_cache
    enable_compile_cache()

    from bench import get_model
    from sip_optimal_control_tpu import Settings, build_problem, solve
    from sip_optimal_control_tpu.solver.settings import LineSearchSettings

    spec, dims, topo, lower, upper, x0 = get_model("cartpole", args.horizon)
    B = args.batch
    rng = np.random.default_rng(0)
    x0s = jnp.asarray(np.asarray(x0, np.float32)[None]
                      + 0.1 * rng.standard_normal((B, 4)).astype(np.float32))

    f32 = dict(mu_min=1e-5, reg_floor=1e-5, prox_reg=1e-5,
               riccati_backend="pallas")

    # one cold solve -> realistic warm state
    def cold_one(x0_i):
        p = build_problem(spec, dims, topo, initial_state=x0_i,
                          lower=lower, upper=upper)
        r = solve(p, Settings(max_iterations=100, tol=1e-3, **f32))
        return r.vars, r.y
    wv, wy = jax.block_until_ready(jax.jit(jax.vmap(cold_one))(x0s))

    print(f"# device={jax.devices()[0].device_kind} batch={B} "
          f"horizon={args.horizon} tol=0 (forced full iteration count)")
    for hessian in ("exact", "gauss_newton"):
        for ls_steps in (25, 4):
            times = {}
            for K in (2, 8):
                settings = Settings(
                    max_iterations=K, tol=0.0, mu_init=1e-4,
                    line_search=LineSearchSettings(max_steps=ls_steps),
                    **f32)

                def warm_one(x0_i, v, y):
                    p = build_problem(spec, dims, topo, initial_state=x0_i,
                                      lower=lower, upper=upper,
                                      hessian_mode=hessian)
                    r = solve(p, settings, init_vars=v, init_y=y)
                    return r.kkt_error, r.iterations
                fn = jax.jit(jax.vmap(warm_one))
                out = jax.block_until_ready(fn(x0s, wv, wy))
                assert int(np.asarray(out[1]).max()) == K, out[1]
                ts = []
                for _ in range(args.reps):
                    t0 = time.time()
                    jax.block_until_ready(fn(x0s, wv, wy))
                    ts.append(time.time() - t0)
                times[K] = float(np.median(ts))
            slope = (times[8] - times[2]) / 6.0
            fixed = times[2] - 2 * slope
            print(f"hessian={hessian:13s} ls_steps={ls_steps:2d} "
                  f"t(K=2)={times[2]*1e3:8.2f}ms t(K=8)={times[8]*1e3:8.2f}ms"
                  f"  per-iter={slope*1e3:7.2f}ms fixed={fixed*1e3:7.2f}ms")


if __name__ == "__main__":
    main()

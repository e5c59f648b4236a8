"""Per-component timing of one IPM iteration on the ambient device.

CAVEAT (r3, COVERAGE.md "K-slope methodology"): this stage-isolated
profile is useful for RELATIVE comparison only — it under-reports
absolute in-program costs badly (XLA overlap/DCE hides most of an
isolated stage's time; e.g. eval_fcg reads 0.04 ms here vs ~1.5 ms
measured with chained in-dispatch repetitions).  For ground truth use
the K-slope method (bench.py --rti K at two K values; the slope is the
marginal per-iteration cost) and scripts/profile_trace.py (device-kernel
trace of one dispatch).

Breaks an interior-point iteration into its pipeline stages and times each
as its own jitted dispatch over the full scenario batch:

  model_eval     autodiff derivative evaluation (ModelEval)
  eval_fcg       residual-only evaluation (one line-search probe)
  kkt_factor     condensation + Riccati factor (per backend)
  kkt_solve      RHS condensation + Riccati solve + multiplier recovery
  kkt_residual   the apply_CT/apply_GT stationarity residual

Per-dispatch overhead is reported separately via a no-op dispatch and
subtracted.  Usage:

  python scripts/profile_iteration.py [--model cartpole|chain16]
      [--batch 4096] [--horizon 50] [--backend pallas|scan|assoc]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="cartpole",
                    choices=["cartpole", "quadrotor", "chain16"])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--horizon", type=int, default=50)
    ap.add_argument("--backend", default="pallas",
                    choices=["pallas", "scan", "assoc"])
    ap.add_argument("--hessian", default="exact",
                    choices=["exact", "gauss_newton"])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--inner", type=int, default=9,
                    help="in-dispatch serial repetitions per timing")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from sip_optimal_control_tpu.utils import enable_compile_cache
    enable_compile_cache()

    from bench import get_model
    from sip_optimal_control_tpu import build_problem
    from sip_optimal_control_tpu.ops.kkt import (Regularizations, kkt_factor,
                                                 kkt_solve, apply_CT,
                                                 apply_GT, zero_kkt_vector,
                                                 ConstraintMasks)
    from sip_optimal_control_tpu.solver.sip import (Primal, YVec, ZVec,
                                                    _kkt_from_duals,
                                                    _pack_b)
    from sip_optimal_control_tpu.types import compile_topology

    spec, dims, topo, lower, upper, x0 = get_model(args.model, args.horizon)
    sched = compile_topology(topo)
    masks = ConstraintMasks.build(dims)
    B = args.batch
    N, E = dims.num_nodes, dims.num_edges
    n, m = max(dims.max_state_dim, 1), max(dims.max_control_dim, 1)
    dtype = jnp.float32

    rng = np.random.default_rng(0)
    x0s = jnp.asarray(
        np.asarray(x0, np.float32)[None]
        + 0.1 * rng.standard_normal((B, n)).astype(np.float32))

    def mk_problem(x0_i):
        return build_problem(spec, dims, topo, initial_state=x0_i,
                             lower=lower, upper=upper,
                             hessian_mode=args.hessian)

    # representative iterate: default init + small random duals
    def init_state(x0_i):
        p = mk_problem(x0_i)
        vars0 = p.default_init
        y0 = YVec(dyn=jnp.zeros((N, n), dtype),
                  nc=jnp.zeros((N, dims.max_node_c_dim), dtype),
                  ec=jnp.zeros((E, dims.max_edge_c_dim), dtype))
        z0 = ZVec(n=jnp.ones((N, dims.max_node_g_dim), dtype),
                  e=jnp.ones((E, dims.max_edge_g_dim), dtype))
        return vars0, y0, z0

    vars_b, y_b, z_b = jax.jit(jax.vmap(init_state))(x0s)

    # ---- pieces ------------------------------------------------------------
    def model_eval(x0_i, v, y, z):
        return mk_problem(x0_i).eval_model(v, y, z)

    def fcg(x0_i, v):
        return mk_problem(x0_i).eval_fcg(v)

    ev_b = jax.jit(jax.vmap(model_eval))(x0s, vars_b, y_b, z_b)

    mu = 1e-3
    template = zero_kkt_vector(dims, dtype)

    def mk_regs():
        return Regularizations(
            w_n=jnp.ones((N, dims.max_node_g_dim), dtype),
            w_e=jnp.ones((E, dims.max_edge_g_dim), dtype),
            r1_x=jnp.full((N, n), 1e-5, dtype),
            r1_u=jnp.full((E, m), 1e-5, dtype),
            r1_th=jnp.full((dims.theta_dim,), 1e-5, dtype),
            r2_dyn=jnp.full((N, n), mu, dtype),
            r2_nc=jnp.full((N, dims.max_node_c_dim), mu, dtype),
            r2_ec=jnp.full((E, dims.max_edge_c_dim), mu, dtype),
            r3_n=jnp.full((N, dims.max_node_g_dim), mu, dtype),
            r3_e=jnp.full((E, dims.max_edge_g_dim), mu, dtype))

    regs = mk_regs()

    def factor(stage):
        return kkt_factor(stage, regs, masks, sched, args.backend)

    fact_b = jax.jit(jax.vmap(factor))(ev_b.stage)

    # sub-split of kkt_factor: condensation einsums alone vs the Riccati
    # factorization alone (drives the fuse-or-skip decision for a Pallas
    # condensation kernel)
    from sip_optimal_control_tpu.ops.lqr import lqr_factor as _lqr_factor

    def condense_only(stage):
        f = kkt_factor(stage, regs, masks, sched, args.backend)
        return f.lqr_data

    def riccati_only(lqr_data):
        return _lqr_factor(lqr_data, sched, args.backend)

    lqr_data_b = jax.jit(jax.vmap(condense_only))(ev_b.stage)

    bvec = jax.vmap(lambda v, y, z: _pack_b(
        v, y, z, dims.theta_dim, template))(vars_b, y_b, z_b)

    def solve_piece(f, stage, b):
        return kkt_solve(f, stage, b, sched, args.backend)

    # sub-split of kkt_solve: the Riccati vector solve alone vs the RHS
    # condensation + multiplier recovery epilogue
    from sip_optimal_control_tpu.ops.lqr import lqr_solve as _lqr_solve

    def riccati_solve_only(f, b):
        import dataclasses as _dc
        data = _dc.replace(f.lqr_data, q=b.x, r=b.u, c=b.y_dyn)
        return _lqr_solve(data, f.lqr_fact, sched, args.backend)

    def resid_piece(stage, v, y, z):
        duals = _kkt_from_duals(template, y, z)
        ct = apply_CT(stage, duals, sched)
        gt = apply_GT(stage, duals, sched)
        return ct.x + gt.x, ct.u + gt.u

    pieces = {
        "model_eval": (jax.vmap(model_eval), (x0s, vars_b, y_b, z_b)),
        "eval_fcg": (jax.vmap(fcg), (x0s, vars_b)),
        f"kkt_factor[{args.backend}]": (jax.vmap(factor), (ev_b.stage,)),
        "  - condense": (jax.vmap(condense_only), (ev_b.stage,)),
        "  - riccati_factor": (jax.vmap(riccati_only), (lqr_data_b,)),
        f"kkt_solve[{args.backend}]": (jax.vmap(solve_piece),
                                       (fact_b, ev_b.stage, bvec)),
        "  - riccati_solve": (jax.vmap(riccati_solve_only), (fact_b, bvec)),
        "kkt_residual": (jax.vmap(resid_piece),
                         (ev_b.stage, vars_b, y_b, z_b)),
    }

    # In-dispatch repetition: each piece is applied `inner` times serially
    # inside ONE jitted program, with a vanishing data dependency (acc*1e-30
    # added to every float input) chaining the applications so XLA cannot
    # hoist the loop-invariant computation.  Piece time = (t_R - t_1) /
    # (inner - 1), which cancels the per-dispatch overhead exactly, so
    # sub-millisecond pieces are not swamped by dispatch jitter.
    R = args.inner

    def repeated(fn, fargs, reps):
        def leafsum(t):
            return sum(jnp.sum(jnp.abs(leaf).astype(jnp.float32))
                       for leaf in jax.tree.leaves(t)
                       if jnp.issubdtype(jnp.asarray(leaf).dtype,
                                         jnp.floating))

        def run(*fa):
            def body(i, acc):
                eps = acc * 1e-30
                pert = jax.tree.map(
                    lambda a: a + eps.astype(a.dtype)
                    if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)
                    else a, fa)
                return 1e-30 * leafsum(fn(*pert)) + acc * 0.5
            return jax.lax.fori_loop(0, reps, body, jnp.float32(1.0))
        return jax.jit(run)

    print(f"# device={jax.devices()[0].device_kind} model={args.model} "
          f"batch={B} horizon={args.horizon} backend={args.backend} "
          f"inner_reps={R}")
    results = {}
    for name, (fn, fargs) in pieces.items():
        f1 = repeated(fn, fargs, 1)
        fR = repeated(fn, fargs, R)
        jax.block_until_ready(f1(*fargs))   # compile
        jax.block_until_ready(fR(*fargs))
        t1s, tRs = [], []
        for _ in range(args.reps):
            t0 = time.time()
            jax.block_until_ready(f1(*fargs))
            t1s.append(time.time() - t0)
            t0 = time.time()
            jax.block_until_ready(fR(*fargs))
            tRs.append(time.time() - t0)
        t = max(float(np.median(tRs)) - float(np.median(t1s)), 0.0) / (R - 1)
        results[name] = t
        print(f"{name:24s} {t * 1e3:9.3f} ms/batch "
              f"({t / B * 1e6:8.3f} us/scenario)")
    # sub-splits (names starting with whitespace) are inside kkt_factor and
    # excluded from the total
    total = sum(t for nm, t in results.items() if not nm.startswith(" "))
    print(f"{'TOTAL (1 iter + 1 probe)':24s} {total * 1e3:9.3f} ms/batch")
    for name, t in results.items():
        if not name.startswith(" "):
            print(f"  {name:22s} {100.0 * t / max(total, 1e-12):5.1f}%")


if __name__ == "__main__":
    main()

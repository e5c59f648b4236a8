"""Newton-KKT condensation + solve benchmarks.

Mirrors the reference's BM_NewtonKKT{Factor,Solve,FactorSolve,Residual} over
T in {16,32,64,128} x n in {4,6,8,16} x m in {1,2,3,4} with
c_dim = max(1, n/2), g_dim = 2m
(reference: benchmarks/newton_kkt_benchmark.cpp:58-64,439-442), and the
theta variants BM_NewtonKKTTheta* over T in {32,64,128} x n in {8,16} x
m in {2,4} x p in {4,8} (reference: newton_kkt_benchmark.cpp:253-263,
443-446).  The Residual case times one apply_K operator application
(the reference's residual oracle).

Usage: python benchmarks/newton_kkt_benchmark.py [--quick] [--batch 512] [--json out.json]
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from common import base_parser, report, timer


def make_model(dims, topo, rng):
    """Random well-posed uniform-dims stage model (the benchmark analogue of
    the reference's initialize_kkt_data, newton_kkt_benchmark.cpp:66-160)."""
    import jax.numpy as jnp
    from sip_optimal_control_tpu.ops.kkt import StageModelData

    N, E = topo.num_nodes, topo.num_edges
    n, m, p = dims.max_state_dim, dims.max_control_dim, dims.theta_dim
    cn, ce = dims.max_node_c_dim, dims.max_edge_c_dim
    gn, ge = dims.max_node_g_dim, dims.max_edge_g_dim

    def spd(count, d, base):
        if d == 0:
            return np.zeros((count, d, d))
        s = 0.2 * rng.standard_normal((count, d, d))
        return s @ np.swapaxes(s, -1, -2) + base * np.eye(d)

    def rand(*shape, scale=0.3):
        return scale * rng.standard_normal(shape)

    kw = dict(
        f_node=np.zeros(N), f_edge=np.zeros(E),
        df_dx_node=rand(N, n), df_dx_edge=rand(E, n), df_du=rand(E, m),
        dyn_res=rand(E, n), A=rand(E, n, n, scale=0.5),
        B=rand(E, n, m, scale=0.5),
        c_node=rand(N, cn), Jc_x_node=rand(N, cn, n),
        c_edge=rand(E, ce), Jc_x_edge=rand(E, ce, n),
        Jc_u_edge=rand(E, ce, m),
        g_node=rand(N, gn), Jg_x_node=rand(N, gn, n),
        g_edge=rand(E, ge), Jg_x_edge=rand(E, ge, n),
        Jg_u_edge=rand(E, ge, m),
        Hxx_node=spd(N, n, 2.5), Hxx_edge=spd(E, n, 0.3),
        Hxu_edge=rand(E, n, m, scale=0.05), Huu_edge=spd(E, m, 3.0),
        df_dtheta_node=rand(N, p), df_dtheta_edge=rand(E, p),
        ddyn_dtheta=rand(E, n, p, scale=0.05),
        Jc_th_node=rand(N, cn, p, scale=0.05),
        Jc_th_edge=rand(E, ce, p, scale=0.05),
        Jg_th_node=rand(N, gn, p, scale=0.05),
        Jg_th_edge=rand(E, ge, p, scale=0.05),
        Hxth_node=rand(N, n, p, scale=0.05),
        Hxth_edge=rand(E, n, p, scale=0.05),
        Huth_edge=rand(E, m, p, scale=0.05),
        Hthth_node=spd(N, p, 6.0), Hthth_edge=spd(E, p, 6.0))
    return StageModelData(**{k: jnp.asarray(v) for k, v in kw.items()})


def make_regs(dims, rng):
    import jax.numpy as jnp
    from sip_optimal_control_tpu.ops.kkt import Regularizations
    N, E = dims.num_nodes, dims.num_edges

    def pos(*shape):
        return jnp.asarray(0.3 + rng.random(shape))

    return Regularizations(
        w_n=pos(N, dims.max_node_g_dim), w_e=pos(E, dims.max_edge_g_dim),
        r1_x=pos(N, dims.max_state_dim), r1_u=pos(E, dims.max_control_dim),
        r1_th=pos(dims.theta_dim),
        r2_dyn=pos(N, dims.max_state_dim), r2_nc=pos(N, dims.max_node_c_dim),
        r2_ec=pos(E, dims.max_edge_c_dim), r3_n=pos(N, dims.max_node_g_dim),
        r3_e=pos(E, dims.max_edge_g_dim))


def main():
    args = base_parser(__doc__).parse_args()

    import jax
    import jax.numpy as jnp
    from sip_optimal_control_tpu import (Dimensions, Topology,
                                         compile_topology)
    from sip_optimal_control_tpu.ops.kkt import (ConstraintMasks, apply_K,
                                                 kkt_factor, kkt_solve,
                                                 zero_kkt_vector)

    if args.quick:
        grid = [(16, 4, 1), (32, 8, 2)]
        theta_grid = [(32, 8, 2, 4)]
    else:
        grid = [(T, n, m)
                for T in (16, 32, 64, 128)
                for n in (4, 6, 8, 16)
                for m in (1, 2, 3, 4)]
        theta_grid = [(T, n, m, p)
                      for T in (32, 64, 128)
                      for n in (8, 16)
                      for m in (2, 4)
                      for p in (4, 8)]

    rng = np.random.default_rng(0)
    results = []

    def run_case(name, T, n, m, p):
        dims = Dimensions.uniform(
            num_edges=T, state_dim=n, control_dim=m,
            node_c_dim=max(1, n // 2), node_g_dim=2 * m,
            edge_c_dim=0, edge_g_dim=0, theta_dim=p)
        topo = Topology.chain(T)
        sched = compile_topology(topo)
        masks = ConstraintMasks.build(dims)
        model = make_model(dims, topo, rng)
        regs = make_regs(dims, rng)
        b = jax.tree.map(lambda a: jnp.asarray(
            rng.standard_normal(a.shape)), zero_kkt_vector(dims))

        factor = jax.jit(lambda mo, re: kkt_factor(mo, re, masks, sched))
        solve = jax.jit(lambda fa, mo, bb: kkt_solve(fa, mo, bb, sched))
        both = jax.jit(lambda mo, re, bb: kkt_solve(
            kkt_factor(mo, re, masks, sched), mo, bb, sched))
        residual = jax.jit(lambda mo, re, vv: apply_K(mo, re, vv, sched))

        fact = jax.block_until_ready(factor(model, regs))
        assert int(np.asarray(fact.status)) == 0, name
        sol = solve(fact, model, b)
        resid = float((apply_K(model, regs, sol, sched) - b).norm())

        for op, fn, fargs in (
                ("Factor", factor, (model, regs)),
                ("Solve", solve, (fact, model, b)),
                ("FactorSolve", both, (model, regs, b)),
                ("Residual", residual, (model, regs, sol))):
            tmin, tmed = timer(fn, fargs, args.reps)
            results.append(dict(name=f"{name}{op}/T:{T}/n:{n}/m:{m}"
                                + (f"/p:{p}" if p else ""),
                                time_min_s=tmin, time_median_s=tmed,
                                residual_norm=resid))

    for T, n, m in grid:
        run_case("BM_NewtonKKT", T, n, m, 0)
    for T, n, m, p in theta_grid:
        run_case("BM_NewtonKKTTheta", T, n, m, p)

    report(results, args.json)


if __name__ == "__main__":
    main()

"""Tree-LQR factor/solve benchmarks.

Mirrors the reference's BM_LQR{Factor,Solve,FactorSolve} over the grid
T in {16,32,64,128} x n in {4,6,8,16} x m in {1,2,3,4}
(reference: benchmarks/lqr_benchmark.cpp:537-545,746-748) and the tree-shape
variants over T in {31,63} (reference: lqr_benchmark.cpp:547-555,749-751);
every case reports the regularized-KKT residual norm as a correctness
counter (reference: lqr_benchmark.cpp:533-534).  `--batch B` adds
vmapped-throughput variants, the number that matters on an accelerator.

Usage: python benchmarks/lqr_benchmark.py [--quick] [--batch 1024] [--json out.json]
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from common import (base_parser, make_chain_lqr, report, timer,
                    tree_topologies)


def main():
    args = base_parser(__doc__).parse_args()

    import jax
    import jax.numpy as jnp
    from sip_optimal_control_tpu import Topology, compile_topology
    from sip_optimal_control_tpu.ops.lqr import (lqr_factor, lqr_residual_norm,
                                                 lqr_solve)

    from sip_optimal_control_tpu import Dimensions
    from sip_optimal_control_tpu.ops.lqr import pad_lqr_data

    if args.quick:
        grid = [(16, 4, 1), (32, 8, 2)]
        tree_grid = [(31, 4)]
        var_grid = [(31, 4)]
    else:
        grid = [(T, n, m)
                for T in (16, 32, 64, 128)
                for n in (4, 6, 8, 16)
                for m in (1, 2, 3, 4)]
        tree_grid = [(T, n) for T in (31, 63) for n in (4, 8)]
        var_grid = tree_grid

    rng = np.random.default_rng(0)
    results = []

    def run_case(name, data, sched, batch=0):
        factor = jax.jit(lambda d: lqr_factor(d, sched))
        solve = jax.jit(lambda d, f: lqr_solve(d, f, sched))
        both = jax.jit(lambda d: lqr_solve(d, lqr_factor(d, sched), sched))
        if batch:
            factor = jax.jit(jax.vmap(lambda d: lqr_factor(d, sched)))
            solve = jax.jit(jax.vmap(lambda d, f: lqr_solve(d, f, sched)))
            both = jax.jit(jax.vmap(
                lambda d: lqr_solve(d, lqr_factor(d, sched), sched)))
        fact = jax.block_until_ready(factor(data))
        sol = solve(data, fact)
        if batch:
            resid = float(jnp.max(jax.vmap(
                lambda d, s: lqr_residual_norm(d, s, sched))(data, sol)))
        else:
            resid = float(lqr_residual_norm(data, sol, sched))
        for op, fn, fargs in (("Factor", factor, (data,)),
                              ("Solve", solve, (data, fact)),
                              ("FactorSolve", both, (data,))):
            tmin, tmed = timer(fn, fargs, args.reps)
            entry = dict(name=f"{name}{op}", time_min_s=tmin,
                         time_median_s=tmed, residual_norm=resid)
            if batch:
                entry["throughput_per_s"] = batch / tmin
            results.append(entry)

    for T, n, m in grid:
        sched = compile_topology(Topology.chain(T))
        data = make_chain_lqr(n, m, T, rng)
        run_case(f"BM_LQR/T:{T}/n:{n}/m:{m}/", data, sched)
        if args.batch:
            bdata = make_chain_lqr(n, m, T, rng, batch=args.batch)
            run_case(f"BM_LQRBatched/T:{T}/n:{n}/m:{m}/b:{args.batch}/",
                     bdata, sched, batch=args.batch)

    for T, n in tree_grid:
        for shape, topo in tree_topologies(T).items():
            if shape == "path":
                continue
            sched = compile_topology(topo)
            data = make_chain_lqr(n, max(1, n // 4), T, rng)
            run_case(f"BM_LQRTree/{shape}/T:{T}/n:{n}/", data, sched)

    # Heterogeneous per-stage dims over the same tree shapes — the
    # reference's BM_LQRVariable{Factor,Solve,FactorSolve} grid
    # (reference: lqr_benchmark.cpp:209-271 builds state_dims[node] =
    # max(1, base_n + node%3 - 1), control_dims[edge] = max(1, base_m +
    # edge%3 - 1) with base_m=2; grid at :547-555).  This design pads
    # every stage to max dims and masks (SURVEY 2.2), so these rows
    # measure the padding-waste cost relative to the uniform rows above
    # (VERDICT r3 missing #3).
    base_m = 2
    for T, base_n in var_grid:
        state_dims = tuple(max(1, base_n + (i % 3) - 1)
                           for i in range(T + 1))
        control_dims = tuple(max(1, base_m + (e % 3) - 1)
                             for e in range(T))
        dims = Dimensions(
            theta_dim=0, state_dims=state_dims, control_dims=control_dims,
            node_c_dims=(0,) * (T + 1), node_g_dims=(0,) * (T + 1),
            edge_c_dims=(0,) * T, edge_g_dims=(0,) * T)
        n_max, m_max = max(state_dims), max(control_dims)
        for shape, topo in tree_topologies(T).items():
            if shape == "path":
                continue
            sched = compile_topology(topo)
            raw = make_chain_lqr(n_max, m_max, T, rng)
            data = jax.jit(lambda d: pad_lqr_data(d, dims, sched))(raw)
            run_case(f"BM_LQRVariable/{shape}/T:{T}/base_n:{base_n}/",
                     data, sched)

    report(results, args.json)


if __name__ == "__main__":
    main()

"""Measure the vmapped multi-RHS theta solve vs a per-column loop.

A documented deviation (COVERAGE.md): the reference implements a
hand-strided multi-column Riccati recursion for `num_rhs > 1`
(reference: helpers.cpp:422-747) so the p theta-Jacobian columns share one
pass over the factorization; this repo instead `jax.vmap`s the single-RHS
stagewise solve over the p columns (ops/kkt.py::kkt_factor).  Under vmap,
XLA turns every per-stage matvec into an [n, p] matmul reading the factor
ONCE per stage — which is exactly what the strided recursion does by hand.

This script measures, on the reference's theta benchmark grid
(reference: benchmarks/newton_kkt_benchmark.cpp:253-263 — T in {32,64,128},
n in {8,16}, m in {2,4}, p in {4,8}, c = n/2, g = 2m), the full
`kkt_factor` (which contains the multi-RHS solve + Schur assembly) for:
  (a) the shipped vmap path, and
  (b) a per-column `lax.scan`-free Python-loop path (p separate solves) —
      the naive alternative a strided implementation would beat.
If (a) is roughly flat in p and clearly ahead of (b), the vmap deviation
is validated: there is no strided-recursion win left on the table.

Run on the GPU:  python scripts/measure_theta_multirhs.py
CPU sanity:      JAX_PLATFORMS=cpu python scripts/measure_theta_multirhs.py
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

import jax
import jax.numpy as jnp

from sip_optimal_control_tpu.utils import enable_compile_cache  # noqa: E402
from sip_optimal_control_tpu.types import (Dimensions, Topology,  # noqa: E402
                                           compile_topology)
from sip_optimal_control_tpu.ops import kkt as K  # noqa: E402
from test_kkt import make_regs, synthetic_model  # noqa: E402

enable_compile_cache()


def time_fn(fn, *args, reps=20):
    out = jax.block_until_ready(fn(*args))  # compile
    best = np.inf
    for _ in range(reps):
        t0 = time.time()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.time() - t0)
    return best, out


def loop_factor(model, regs, masks, sched, dims, backend):
    """kkt_factor with the multi-RHS theta solve replaced by a Python loop
    of p single-RHS solves (the naive per-column alternative)."""
    fact = K.kkt_factor(model, regs, masks, sched, backend=backend)
    # redo the theta solve as p separate solves to measure the difference
    j_theta = K._theta_jacobian_columns(model, sched)
    cols = []
    p = dims.theta_dim
    for i in range(p):
        col = jax.tree.map(lambda a: a[i], j_theta)
        cols.append(K._solve_stagewise(fact, model, col, sched, backend))
    k_inv_j = jax.tree.map(lambda *xs: jnp.stack(xs), *cols)
    s_theta = (jnp.sum(model.Hthth_node, axis=0)
               + jnp.sum(model.Hthth_edge, axis=0)
               + jnp.diag(regs.r1_th)
               - K._theta_dot(j_theta, k_inv_j))
    s_chol, _ = K.cholesky_with_ok(s_theta)
    return fact._replace(theta_solution=k_inv_j, theta_schur_chol=s_chol)


def main():
    batch = int(os.environ.get("THETA_BENCH_BATCH", "64"))
    rows = []
    for T in (32, 64, 128):
        for n in (8, 16):
            for m in (2, 4):
                for p in (4, 8):
                    dims = Dimensions.uniform(
                        num_edges=T, state_dim=n, control_dim=m,
                        node_c_dim=max(1, n // 2), node_g_dim=2 * m,
                        theta_dim=p)
                    topo = Topology.chain(T)
                    sched = compile_topology(topo)
                    rng = np.random.default_rng(0)
                    masks = K.ConstraintMasks.build(dims)
                    model = synthetic_model(dims, topo, rng)
                    regs = make_regs(dims, masks, rng,
                                     dtype=jnp.float32)
                    model = jax.tree.map(
                        lambda a: jnp.asarray(a, jnp.float32), model)
                    bmodel = jax.tree.map(
                        lambda a: jnp.broadcast_to(a, (batch,) + a.shape),
                        model)
                    bregs = jax.tree.map(
                        lambda a: jnp.broadcast_to(a, (batch,) + a.shape),
                        regs)

                    vmap_fn = jax.jit(jax.vmap(lambda mo, rg: K.kkt_factor(
                        mo, rg, masks, sched, backend="scan")))
                    loop_fn = jax.jit(jax.vmap(lambda mo, rg: loop_factor(
                        mo, rg, masks, sched, dims, "scan")))
                    t_vmap, _ = time_fn(vmap_fn, bmodel, bregs)
                    t_loop, _ = time_fn(loop_fn, bmodel, bregs)
                    rows.append(dict(T=T, n=n, m=m, p=p, batch=batch,
                                     t_vmap_ms=round(t_vmap * 1e3, 3),
                                     t_loop_ms=round(t_loop * 1e3, 3),
                                     speedup=round(t_loop / t_vmap, 2)))
                    print(json.dumps(rows[-1]), flush=True)
    # summary: is the vmap path ~flat in p?
    by_cfg = {}
    for r in rows:
        by_cfg.setdefault((r["T"], r["n"], r["m"]), {})[r["p"]] = r
    growth = [c[8]["t_vmap_ms"] / c[4]["t_vmap_ms"] for c in by_cfg.values()]
    print(json.dumps({
        "platform": jax.default_backend(),
        "median_speedup_vs_column_loop": round(
            float(np.median([r["speedup"] for r in rows])), 2),
        "median_t_growth_p4_to_p8": round(float(np.median(growth)), 2),
        "note": "growth ~1.0 = factor reads shared across columns "
                "(what the reference's strided recursion achieves)",
    }))


if __name__ == "__main__":
    main()

"""Chain-Riccati factor + solve on a scenario batch: the Pallas (Triton)
kernels against the `lax.scan` and associative-scan backends.

For each width (n, m) it checks the kernels once against the scan (run
under "highest" matmul precision), then times factor + solve for every
backend and for each kernel launch configuration (scenarios per program x
warps per program).  Widths above the dispatch's state-dim threshold
(`_MAX_N`, where solves run the scan) time the kernels only with
--above-max-n; every timing reports its compile time.  One JSON object per
line on stdout.  Needs a GPU.

Usage: python benchmarks/riccati_kernel_benchmark.py [--batch 4096]
    [--horizon 50] [--widths 4x1,6x2,16x4] [--xla scan,assoc]
    [--blocks 32,64,128] [--warps 1,2,4] [--reps 20] [--above-max-n]
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))


def _time(fn, args, reps):
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), float(np.min(times)), compile_s


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--horizon", type=int, default=50)
    ap.add_argument("--widths", default="4x1,6x2,16x4")
    ap.add_argument("--xla", default="scan,assoc",
                    help="XLA backends to time ('' for none)")
    ap.add_argument("--above-max-n", action="store_true",
                    help="also time the kernels at widths with n > _MAX_N")
    ap.add_argument("--blocks", default="32,64,128")
    ap.add_argument("--warps", default="1,2,4")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from common import random_chain_batch
    from sip_optimal_control_tpu import Topology, compile_topology
    from sip_optimal_control_tpu.ops.lqr import (lqr_factor,
                                                 lqr_residual_norm, lqr_solve)
    from sip_optimal_control_tpu.ops.pallas_riccati import (
        _MAX_N, factor_chain_triton, solve_chain_triton)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU; found {dev.platform}")
    T, B = args.horizon, args.batch
    sched = compile_topology(Topology.chain(T))
    resid = jax.jit(jax.vmap(lambda d, s: lqr_residual_norm(d, s, sched)))

    def emit(**rec):
        print(json.dumps(dict(rec, device=dev.device_kind, T=T, batch=B)),
              flush=True)

    for wi, width in enumerate(args.widths.split(",")):
        n, m = (int(v) for v in width.split("x"))
        data = random_chain_batch(jax.random.key(wi), T, n, m, B)

        def xla(backend):
            def run(d):
                f = lqr_factor(d, sched, backend)
                return lqr_solve(d, f, sched, backend), f.status
            return jax.jit(jax.vmap(run))

        def kernel(block_b, num_warps):
            kw = dict(block_b=block_b, num_warps=num_warps)

            def run(d):
                f = factor_chain_triton(d, **kw)
                return solve_chain_triton(d, f, **kw), f.status
            return jax.jit(run)

        for backend in filter(None, args.xla.split(",")):
            med, best, comp = _time(xla(backend), (data,), args.reps)
            emit(kind="time", n=n, m=m, backend=backend, median_ms=med * 1e3,
                 min_ms=best * 1e3, compile_s=comp)
        if n > _MAX_N and not args.above_max_n:
            continue        # the dispatch runs the scan at this width
        with jax.default_matmul_precision("highest"):
            ref_sol, ref_st = xla("scan")(data)
        got_sol, got_st = kernel(32, 1)(data)
        emit(kind="parity", n=n, m=m,
             statuses_equal=bool(jnp.all(ref_st == got_st)),
             resid_scan=float(jnp.max(resid(data, ref_sol))),
             resid_kernel=float(jnp.max(resid(data, got_sol))),
             **{f"max_abs_diff_{k}": float(jnp.max(jnp.abs(
                 getattr(got_sol, k) - getattr(ref_sol, k))))
                for k in ("x", "u", "y")})
        for block_b in (int(v) for v in args.blocks.split(",")):
            for num_warps in (int(v) for v in args.warps.split(",")):
                med, best, comp = _time(kernel(block_b, num_warps),
                                        (data,), args.reps)
                emit(kind="time", n=n, m=m, backend="pallas",
                     block_b=block_b, num_warps=num_warps,
                     median_ms=med * 1e3, min_ms=best * 1e3, compile_s=comp)


if __name__ == "__main__":
    main()

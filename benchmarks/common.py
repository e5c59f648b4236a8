"""Shared benchmark utilities: problem generators, timing, JSON reporting.

The counterpart of the reference's google_benchmark harnesses
(reference: benchmarks/lqr_benchmark.cpp, benchmarks/newton_kkt_benchmark.cpp):
each case reports wall time per op plus the correctness counter
`residual_norm` (reference: lqr_benchmark.cpp:533-534), and the grids mirror
the reference's T/n/m (and theta) sweeps.  An extra `--batch` axis measures
vmapped throughput — the quantity that matters on an accelerator.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def timer(fn, args, reps: int, warmup: int = 2):
    """Min/median wall time of a jitted callable (args pre-staged)."""
    import jax
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.min(times)), float(np.median(times))


def make_chain_lqr(n: int, m: int, T: int, rng, batch: int = 0):
    """Random well-posed chain LQR data, the analogue of LQRProblem
    (reference: lqr_benchmark.cpp:47-99): SPD Q/R, random A/B/M, positive
    delta."""
    import jax.numpy as jnp
    from sip_optimal_control_tpu.ops.lqr import LQRData

    def spd(count, d, base):
        s = 0.3 * rng.standard_normal((count, d, d))
        return s @ np.swapaxes(s, -1, -2) + base * np.eye(d)

    shapes = dict(
        Q=spd(T + 1, n, 2.0),
        q=rng.standard_normal((T + 1, n)),
        c=rng.standard_normal((T + 1, n)),
        delta=0.5 + rng.random((T + 1, n)),
        A=0.5 * rng.standard_normal((T, n, n)),
        B=0.5 * rng.standard_normal((T, n, m)),
        M=0.1 * rng.standard_normal((T, n, m)),
        R=spd(T, m, 2.0),
        r=rng.standard_normal((T, m)),
    )
    if batch:
        shapes = {k: np.broadcast_to(v, (batch,) + v.shape).copy()
                  for k, v in shapes.items()}
        # decorrelate the batch through the linear terms (cheap)
        shapes["q"] += rng.standard_normal(shapes["q"].shape)
    return LQRData(**{k: jnp.asarray(v) for k, v in shapes.items()})


def random_chain_batch(key, T: int, n: int, m: int, batch: int,
                       dtype="float32"):
    """`batch` independent random well-conditioned chain LQR problems, drawn
    on the default device from `key`: SPD Q/R, random A/B/M, delta in
    [0.5, 1.5).  Leading batch axis on every field."""
    import jax
    import jax.numpy as jnp
    from sip_optimal_control_tpu.ops.lqr import LQRData

    ks = jax.random.split(key, 9)

    def normal(k, shape):
        return jax.random.normal(k, (batch,) + shape, dtype)

    def spd(k, count, d):
        s = 0.3 * normal(k, (count, d, d))
        return (jnp.einsum("...ij,...kj->...ik", s, s, precision="highest")
                + 2.0 * jnp.eye(d, dtype=dtype))

    return LQRData(
        Q=spd(ks[0], T + 1, n), q=normal(ks[1], (T + 1, n)),
        c=normal(ks[2], (T + 1, n)),
        delta=0.5 + jax.random.uniform(ks[3], (batch, T + 1, n), dtype),
        A=0.4 * normal(ks[4], (T, n, n)), B=0.5 * normal(ks[5], (T, n, m)),
        M=0.1 * normal(ks[6], (T, n, m)), R=spd(ks[7], T, m),
        r=normal(ks[8], (T, m)))


def tree_topologies(T: int):
    """The reference's tree benchmark shapes
    (reference: lqr_benchmark.cpp:209-271): a path, a shallow-wide tree
    (root with T children), and a complete binary tree with T edges."""
    from sip_optimal_control_tpu import Topology
    shallow = Topology.tree(0, [0] * T, list(range(1, T + 1)))
    parents = [(k - 1) // 2 for k in range(1, T + 1)]
    binary = Topology.tree(0, parents, list(range(1, T + 1)))
    # heterogeneous_path: a depth-T path built through the GENERAL tree
    # constructor (is_chain=False), so it runs the tree recursion — the
    # deep-tree lax.scan level backend — not the chain fast path
    het_path = Topology.tree(0, list(range(T)), list(range(1, T + 1)))
    return {"path": Topology.chain(T), "heterogeneous_path": het_path,
            "shallow_wide_tree": shallow, "binary_tree": binary}


def report(results, json_path=None):
    for r in results:
        print(f"{r['name']:<58s} {r['time_min_s'] * 1e6:>12.1f} us   "
              f"residual={r['residual_norm']:.2e}"
              + (f"   {r['throughput_per_s']:.0f}/s"
                 if "throughput_per_s" in r else ""))
    if json_path:
        with open(json_path, "w") as f:
            json.dump(results, f, indent=1)


def base_parser(desc):
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--quick", action="store_true",
                   help="small sub-grid (CI smoke)")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--batch", type=int, default=0,
                   help="also run vmapped-throughput variants at this batch")
    p.add_argument("--json", type=str, default=None)
    return p

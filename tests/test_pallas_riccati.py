"""Chain-Riccati Pallas (Triton) kernel tests, interpret mode on CPU.

The kernels must reproduce the scan backend's factorization products and
solutions on batched f32 data, and propagate failure statuses per
scenario.  `backend="pallas"` itself runs the scan off CUDA (unbatched,
f64 and CPU-lowered calls), which the last test pins."""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from sip_optimal_control_tpu import FactorStatus, Topology, compile_topology
from sip_optimal_control_tpu.ops.lqr import (LQRData, lqr_factor,
                                             lqr_factor_solve,
                                             lqr_residual_norm, lqr_solve)
from sip_optimal_control_tpu.ops.pallas_riccati import (factor_chain_triton,
                                                        solve_chain_triton)

kernel_factor = jax.jit(functools.partial(factor_chain_triton,
                                          interpret=True))
kernel_solve = jax.jit(functools.partial(solve_chain_triton, interpret=True))


def random_chain_f32(T, n, m, rng, batch):
    def spd(c, d, base):
        s = 0.3 * rng.standard_normal((c, d, d))
        return (s @ np.swapaxes(s, -1, -2)
                + base * np.eye(d)).astype(np.float32)

    def r32(*sh):
        return rng.standard_normal(sh).astype(np.float32)

    def stack(f):
        return jnp.asarray(np.stack([f() for _ in range(batch)]))

    return LQRData(
        Q=stack(lambda: spd(T + 1, n, 2.0)),
        q=stack(lambda: r32(T + 1, n)),
        c=stack(lambda: r32(T + 1, n)),
        delta=stack(lambda: (0.5 + rng.random((T + 1, n))
                             ).astype(np.float32)),
        A=stack(lambda: 0.4 * r32(T, n, n)),
        B=stack(lambda: 0.5 * r32(T, n, m)),
        M=stack(lambda: 0.1 * r32(T, n, m)),
        R=stack(lambda: spd(T, m, 2.0)),
        r=stack(lambda: r32(T, m)))


def test_pallas_factor_matches_scan_under_vmap():
    rng = np.random.default_rng(0)
    T, n, m, B = 5, 3, 2, 4          # batch padded to BLOCK_B inside
    sched = compile_topology(Topology.chain(T))
    data = random_chain_f32(T, n, m, rng, B)

    f_scan = jax.vmap(lambda d: lqr_factor(d, sched))(data)
    f_pal = kernel_factor(data)
    assert np.all(np.asarray(f_pal.status) == FactorStatus.SUCCESS)
    for name in ("V", "W", "K", "G_chol", "F_chol"):
        np.testing.assert_allclose(
            np.asarray(getattr(f_pal, name)),
            np.asarray(getattr(f_scan, name)), rtol=2e-4, atol=2e-4,
            err_msg=name)


def test_pallas_factor_solve_end_to_end():
    rng = np.random.default_rng(1)
    T, n, m, B = 8, 4, 1, 3
    sched = compile_topology(Topology.chain(T))
    data = random_chain_f32(T, n, m, rng, B)

    fact = kernel_factor(data)
    sols, stats = kernel_solve(data, fact), fact.status
    assert np.all(np.asarray(stats) == FactorStatus.SUCCESS)
    resid = jax.vmap(lambda d, s: lqr_residual_norm(d, s, sched))(data, sols)
    # f32 recursion; residual is small relative to O(1) data
    assert float(jnp.max(resid)) < 5e-4, float(jnp.max(resid))

    sols_ref, _ = jax.vmap(lambda d: lqr_factor_solve(d, sched))(data)
    np.testing.assert_allclose(np.asarray(sols.x), np.asarray(sols_ref.x),
                               rtol=2e-3, atol=2e-3)


def test_pallas_per_scenario_failure_status():
    rng = np.random.default_rng(2)
    T, n, m, B = 4, 3, 1, 3
    sched = compile_topology(Topology.chain(T))
    data = random_chain_f32(T, n, m, rng, B)
    # scenario 1 gets a non-PD R at one stage -> G failure for it only
    R_bad = data.R.at[1, 2].set(-jnp.eye(m, dtype=jnp.float32))
    data = dataclasses.replace(data, R=R_bad)
    f = kernel_factor(data)
    stats = np.asarray(f.status)
    assert stats[0] == FactorStatus.SUCCESS
    assert stats[1] != FactorStatus.SUCCESS
    assert stats[2] == FactorStatus.SUCCESS


def test_pallas_unbatched_and_f64_fall_back():
    rng = np.random.default_rng(3)
    T, n, m = 4, 3, 1
    sched = compile_topology(Topology.chain(T))
    data32 = jax.tree.map(lambda a: a[0], random_chain_f32(T, n, m, rng, 1))
    # unbatched direct call -> scan fallback, still correct
    sol, st = lqr_factor_solve(data32, sched, backend="pallas")
    assert int(st) == FactorStatus.SUCCESS
    assert float(lqr_residual_norm(data32, sol, sched)) < 5e-4
    # f64 batched -> vmap(scan) fallback, full fp64 accuracy
    data64 = jax.tree.map(lambda a: jnp.stack([a, a]).astype(jnp.float64),
                          data32)
    sols, sts = jax.vmap(
        lambda d: lqr_factor_solve(d, sched, backend="pallas"))(data64)
    resid = jax.vmap(lambda d, s: lqr_residual_norm(d, s, sched))(data64,
                                                                  sols)
    assert float(jnp.max(resid)) < 1e-10
    # batched f32 on the CPU: the platform-dependent choice runs the scan
    data32b = jax.tree.map(lambda a: jnp.stack([a, a]), data32)
    run = jax.jit(jax.vmap(
        lambda d: lqr_factor_solve(d, sched, backend="pallas")))
    assert "triton" not in run.trace(data32b).lower(
        lowering_platforms=("cpu",)).as_text()
    sols, sts = run(data32b)
    assert np.all(np.asarray(sts) == FactorStatus.SUCCESS)


def test_pallas_gram_kernel_large_n_matches_scan():
    """The Gram-form factor kernel (no F_inv/W/WA in-kernel; W recomputed
    in one batched pass outside) must reproduce the scan backend's
    products and solutions at the reference grid's top end (n=16, m=4)."""
    rng = np.random.default_rng(5)
    T, n, m, B = 6, 16, 4, 3
    sched = compile_topology(Topology.chain(T))
    data = random_chain_f32(T, n, m, rng, B)

    f_scan = jax.vmap(lambda d: lqr_factor(d, sched))(data)
    f_pal = kernel_factor(data)
    assert np.all(np.asarray(f_pal.status) == FactorStatus.SUCCESS)
    for name in ("V", "W", "K", "G_chol", "F_chol"):
        np.testing.assert_allclose(
            np.asarray(getattr(f_pal, name)),
            np.asarray(getattr(f_scan, name)), rtol=5e-4, atol=5e-4,
            err_msg=name)

    sols = kernel_solve(data, f_pal)
    sols_ref, _ = jax.vmap(lambda d: lqr_factor_solve(d, sched))(data)
    np.testing.assert_allclose(np.asarray(sols.x), np.asarray(sols_ref.x),
                               rtol=5e-3, atol=5e-3)

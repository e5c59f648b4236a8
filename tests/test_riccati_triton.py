"""The chain-Riccati Triton kernels at the bench widths, and the choice of
path, on CPU.

Interpret mode runs the kernels' arithmetic here.  Lowering for CUDA,
which needs no card, runs the Triton lowering; it catches block shapes
and operations the GPU route refuses before the card sees them."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sip_optimal_control_tpu import FactorStatus, Topology, compile_topology
from sip_optimal_control_tpu.ops import pallas_riccati
from sip_optimal_control_tpu.ops.lqr import (lqr_factor, lqr_residual_norm,
                                             lqr_solve)
from sip_optimal_control_tpu.ops.pallas_riccati import (factor_chain_triton,
                                                        solve_chain_triton)
from test_pallas_riccati import random_chain_f32

T = 50
BLOCK_B = 32
BATCH = BLOCK_B + 1     # not a multiple of BLOCK_B: padding is exercised


def _pallas_program(sched):
    def run(d):
        fact = lqr_factor(d, sched, backend="pallas")
        return lqr_solve(d, fact, sched, backend="pallas"), fact.status
    return jax.jit(jax.vmap(run))


@pytest.mark.parametrize("n,m", [(4, 1), (6, 2), (16, 4)])
def test_kernel_matches_scan_at_bench_widths(n, m):
    sched = compile_topology(Topology.chain(T))
    data = random_chain_f32(T, n, m, np.random.default_rng(n), BATCH)
    kw = dict(block_b=BLOCK_B, interpret=True)
    fact = jax.jit(functools.partial(factor_chain_triton, **kw))(data)
    sol = jax.jit(functools.partial(solve_chain_triton, **kw))(data, fact)

    f_ref = jax.vmap(lambda d: lqr_factor(d, sched))(data)
    s_ref = jax.vmap(lambda d, f: lqr_solve(d, f, sched))(data, f_ref)
    np.testing.assert_array_equal(np.asarray(fact.status),
                                  np.asarray(f_ref.status))
    assert np.all(np.asarray(fact.status) == FactorStatus.SUCCESS)
    for name in ("V", "K", "G_chol", "F_chol", "W"):
        np.testing.assert_allclose(
            np.asarray(getattr(fact, name)), np.asarray(getattr(f_ref, name)),
            rtol=1e-3, atol=1e-3, err_msg=name)
    for name in ("x", "u", "y"):
        assert getattr(sol, name).shape == getattr(s_ref, name).shape
        np.testing.assert_allclose(
            np.asarray(getattr(sol, name)), np.asarray(getattr(s_ref, name)),
            rtol=1e-3, atol=1e-3, err_msg=name)
    resid = jax.vmap(lambda d, s: lqr_residual_norm(d, s, sched))(data, sol)
    assert float(jnp.max(resid)) < 1e-3


@pytest.mark.parametrize("n,m", [(4, 1), (6, 2)])
@pytest.mark.parametrize("platform", ["cuda", "cpu"])
def test_lowering_picks_kernel_only_for_cuda(n, m, platform):
    """Lowered for CUDA, the vmapped pallas backend holds the three Triton
    calls (factor, backward, forward); lowered for the CPU it holds none.
    The lowering also runs Triton's block-shape checks at these widths."""
    sched = compile_topology(Topology.chain(T))
    data = jax.tree.map(
        lambda a: jax.ShapeDtypeStruct((BATCH,) + a.shape[1:], a.dtype),
        random_chain_f32(T, n, m, np.random.default_rng(0), 1))
    text = _pallas_program(sched).trace(data).lower(
        lowering_platforms=(platform,)).as_text()
    calls = text.count("__gpu$xla.gpu.triton")
    assert calls == (3 if platform == "cuda" else 0), calls


def test_float64_and_wide_state_take_the_scan_on_cuda():
    """The kernels are float32 and n <= _MAX_N only; anything else runs
    the vmapped scan even where the program is lowered for CUDA."""
    sched = compile_topology(Topology.chain(4))

    def spec(n, m, dtype):
        d = random_chain_f32(4, n, m, np.random.default_rng(0), 1)
        return jax.tree.map(
            lambda a: jax.ShapeDtypeStruct((8,) + a.shape[1:], dtype), d)

    for n, dtype in ((4, jnp.float64), (pallas_riccati._MAX_N + 1,
                                        jnp.float32)):
        text = _pallas_program(sched).trace(spec(n, 1, dtype)).lower(
            lowering_platforms=("cuda",)).as_text()
        assert "triton" not in text, (n, dtype)


def test_batch_layout_and_padding_helpers():
    x = jnp.arange(5 * 3 * 2 * 4, dtype=jnp.float32).reshape(5, 3, 2, 4)
    lanes = pallas_riccati._lanes(x)
    assert lanes.shape == (3, 8, 5)
    np.testing.assert_array_equal(np.asarray(lanes[1, 2 * 4 + 3, 4]),
                                  np.asarray(x[4, 1, 2, 3]))
    np.testing.assert_array_equal(
        np.asarray(pallas_riccati._unlanes(lanes, 2, 4)), np.asarray(x))

    data = random_chain_f32(3, 2, 1, np.random.default_rng(0), 5)
    padded = pallas_riccati._pad_batch(
        data, pallas_riccati._inert_data(2, 1, jnp.float32), 3)
    assert padded.Q.shape == (8, 4, 2, 2) and padded.r.shape == (8, 3, 1)
    np.testing.assert_array_equal(np.asarray(padded.Q[:5]),
                                  np.asarray(data.Q))
    np.testing.assert_array_equal(np.asarray(padded.Q[5:]),
                                  np.broadcast_to(np.eye(2), (3, 4, 2, 2)))
    np.testing.assert_array_equal(np.asarray(padded.delta[5:]), 1.0)
    assert pallas_riccati._pad_batch(data, None, 0) is data

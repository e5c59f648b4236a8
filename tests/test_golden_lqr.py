"""Golden-fixture parity against the REAL C++ reference recursion.

tests/golden/lqr_golden.bin was produced by compiling the unmodified
reference `lqr.cpp` (whose Bazel target depends only on Eigen,
reference: sip_optimal_control/BUILD.bazel) against the minimal
Eigen-subset shim (native/eigen_shim/) and dumping seeded factor+solve
problems — see scripts/gen_golden_fixtures.py.  This pins ops/lqr.py to
the genuine reference implementation, closing the BASELINE
"control-trajectory parity <= 1e-6 vs the C++ reference" target: the
measured agreement is ~1e-15 (f64 machine precision) on chains up to
(T=50, n=16, m=4) and on branching trees, for the solution (x, u, y)
AND the factor products (V, K).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp

from sip_optimal_control_tpu import (Dimensions, LQRData, Topology,
                                     compile_topology, lqr_factor,
                                     lqr_solve)
from sip_optimal_control_tpu.ops import pallas_riccati
from sip_optimal_control_tpu.ops.pallas_riccati import (factor_chain_triton,
                                                        solve_chain_triton)

_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "golden", "lqr_golden.bin")
_TOL = 1e-12


def _load_cases():
    buf = np.fromfile(_FIXTURE, dtype="<f8")
    pos = [0]

    def take(k):
        out = buf[pos[0]:pos[0] + k]
        pos[0] += k
        return out

    def mats(S, r, c):
        # stored column-major per matrix
        return take(S * r * c).reshape(S, c, r).transpose(0, 2, 1)

    ncases = int(take(1)[0])
    cases = []
    for _ in range(ncases):
        T, n, m, kind = (int(v) for v in take(4))
        N = T + 1
        Q = mats(N, n, n)
        q = take(N * n).reshape(N, n)
        c = take(N * n).reshape(N, n)
        delta = take(N * n).reshape(N, n)
        A = mats(T, n, n)
        B = mats(T, n, m)
        M = mats(T, n, m)
        R = mats(T, m, m)
        r = take(T * m).reshape(T, m)
        if kind == 1:
            pc = take(2 * T).astype(int)
            topo = Topology.tree(0, tuple(pc[:T]), tuple(pc[T:]))
        else:
            topo = Topology.chain(T)
        x = take(N * n).reshape(N, n)
        u = take(T * m).reshape(T, m)
        y = take(N * n).reshape(N, n)
        V = mats(N, n, n)
        K = mats(T, m, n)
        cases.append((T, n, m, kind, topo,
                      LQRData(Q=jnp.asarray(Q), q=jnp.asarray(q),
                              c=jnp.asarray(c), delta=jnp.asarray(delta),
                              A=jnp.asarray(A), B=jnp.asarray(B),
                              M=jnp.asarray(M), R=jnp.asarray(R),
                              r=jnp.asarray(r)),
                      x, u, y, V, K))
    assert pos[0] == buf.size, "fixture stream not fully consumed"
    return cases


def test_golden_parity_vs_reference():
    assert os.path.exists(_FIXTURE), \
        "missing fixture; run scripts/gen_golden_fixtures.py"
    cases = _load_cases()
    assert len(cases) == 6
    kinds = set()
    for (T, n, m, kind, topo, data, x, u, y, V, K) in cases:
        kinds.add(kind)
        sched = compile_topology(topo)
        fact = lqr_factor(data, sched)
        sol = lqr_solve(data, fact, sched)
        assert int(np.asarray(fact.status).max()) == 0
        for name, got, want in (("x", sol.x, x), ("u", sol.u, u),
                                ("y", sol.y, y), ("V", fact.V, V),
                                ("K", fact.K, K)):
            err = np.max(np.abs(np.asarray(got) - want))
            assert err < _TOL, (T, n, m, kind, name, err)
    assert kinds == {0, 1}          # chains AND trees covered


def test_golden_parity_assoc_and_pallas_backends():
    """The alternative chain backends against the same C++ fixtures: assoc
    at f64, and the float32 Triton kernels in interpret mode at a float32
    tolerance relative to the solution's scale."""
    kernel = jax.jit(lambda d: solve_chain_triton(
        d, factor_chain_triton(d, interpret=True), interpret=True))
    for (T, n, m, kind, topo, data, x, u, y, V, K) in _load_cases():
        if kind != 0:
            continue
        sched = compile_topology(topo)
        fact = lqr_factor(data, sched, backend="assoc")
        sol = lqr_solve(data, fact, sched, backend="assoc")
        for name, got, want in (("x", sol.x, x), ("u", sol.u, u),
                                ("y", sol.y, y)):
            err = np.max(np.abs(np.asarray(got) - want))
            assert err < 1e-9, (T, n, m, name, err)
        if n > pallas_riccati._MAX_N:
            continue        # beyond the kernels' shape rule
        sol32 = kernel(jax.tree.map(lambda a: a[None].astype(jnp.float32),
                                    data))
        for name, got, want in (("x", sol32.x[0], x), ("u", sol32.u[0], u),
                                ("y", sol32.y[0], y)):
            err = np.max(np.abs(np.asarray(got) - want))
            assert err < 1e-4 * max(1.0, np.max(np.abs(want))), (
                T, n, m, name, err)

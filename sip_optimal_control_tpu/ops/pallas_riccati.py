"""Pallas (Triton) kernels for the batched chain-Riccati factor and solve.

XLA runs the scan backend's horizon recursion as a device loop of small
kernels: at least one launch per stage and pass.  These kernels own the
whole horizon loop instead, so one factor plus one solve is three launches
(reference recursion: lqr.cpp:645-871):

  - the grid is one program per block of ``BLOCK_B`` scenarios and nothing
    else; the horizon is an in-kernel ``lax.fori_loop`` whose carry (the
    cost-to-go V, the vector v, or the state x) stays in registers;
  - stage arrays are laid out batch-minor, ``[stages, rows, batch]``, so
    each load of one matrix entry for ``BLOCK_B`` scenarios coalesces;
  - the tiny-matrix algebra (Cholesky, triangular solves, products) is
    unrolled entry-wise at trace time over the static dims n, m; every
    scalar of it is a ``[BLOCK_B]`` vector.

The factor kernel uses the Gram form (see `_gram_core`), which never forms
F^{-1} or W.  F's Cholesky, sqrt(delta), W and the statuses are recomputed
from V outside the kernel in one batched XLA pass over all stages.

Path choice (the public entries are ``custom_vmap``s):
  - unbatched calls run the sequential scan;
  - float64 batches, horizons below 2 and state dims above `_MAX_N` run
    the vmapped scan;
  - float32 batches go through ``lax.platform_dependent``: the kernel where
    the computation is lowered for CUDA, the vmapped scan everywhere else.
    The choice follows the platform the program is lowered for, not the
    process's default backend.
The batch is padded to a multiple of ``BLOCK_B`` with inert identity
stages.  Tests run the kernels on the CPU in Pallas interpret mode.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.custom_batching import custom_vmap
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..types import FactorStatus

# Scenarios per program and warps per program: the fastest point of the
# H100 sweep at (n, m) = (4, 1), within 2% of the best at (6, 2) (PERF.md).
_BLOCK_B = 32
_NUM_WARPS = 1
# State dims above this run the scan.  The unrolled step grows as n^3, and
# so does its compile: on the H100 Triton took ~5 s at n=4, ~35 s at n=6,
# and had not finished the n=16 kernels after ~70 s (PERF.md).
_MAX_N = 6


# ---------------------------------------------------------------------------
# entry-wise tiny-matrix algebra: a matrix is a list of rows, each entry a
# [BLOCK_B] vector (one value per scenario of the block)
# ---------------------------------------------------------------------------

def _mat(ref, s, rows, cols):
    return [[ref[s, i * cols + j, :] for j in range(cols)]
            for i in range(rows)]


def _lower(ref, s, n):
    """Lower triangle of a stored Cholesky factor (upper entries unread)."""
    return [[ref[s, i * n + j, :] if j <= i else None for j in range(n)]
            for i in range(n)]


def _vec(ref, s, d):
    return [ref[s, i, :] for i in range(d)]


def _store(ref, s, values):
    for k, v in enumerate(values):
        ref[s, k, :] = v


def _flat(a):
    return [v for row in a for v in row]


def _sum(terms):
    return functools.reduce(lambda x, y: x + y, terms)


def _transpose(a):
    return [[a[i][j] for i in range(len(a))] for j in range(len(a[0]))]


def _matvec(a, x):
    return [_sum([a[i][k] * x[k] for k in range(len(x))])
            for i in range(len(a))]


def _sqrt_delta(delta):
    safe = [jnp.where(d > 0, d, 1.0) for d in delta]
    sd = [jnp.sqrt(s) for s in safe]
    return sd, [1.0 / s for s in sd]


def _chol(a):
    """Entry-wise lower Cholesky (Cholesky-Banachiewicz), mirroring
    linalg._chol_unrolled; reads the lower triangle of `a` only."""
    n = len(a)
    col = [[None] * n for _ in range(n)]
    for j in range(n):
        s = a[j][j]
        for k in range(j):
            s = s - col[k][j] * col[k][j]
        d = jnp.sqrt(s)
        col[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = a[i][j]
            for k in range(j):
                s = s - col[k][i] * col[k][j]
            col[j][i] = s * inv_d
    return [[col[j][i] if j <= i else jnp.zeros_like(a[0][0])
             for j in range(n)] for i in range(n)]


def _tri_solve_mat(l, b, transpose):
    """Solve L X = B (or L^T X = B) column by column, entries unrolled."""
    n = len(l)
    x = [[None] * len(b[0]) for _ in range(n)]
    order = range(n - 1, -1, -1) if transpose else range(n)
    for j in range(len(b[0])):
        for i in order:
            s = b[i][j]
            for k in (range(i + 1, n) if transpose else range(i)):
                s = s - (l[k][i] if transpose else l[i][k]) * x[k][j]
            x[i][j] = s / l[i][i]
    return x


def _cho_solve_mat(l, b):
    return _tri_solve_mat(l, _tri_solve_mat(l, b, False), True)


def _cho_solve_vec(l, b):
    cols = [[v] for v in b]
    return [row[0] for row in _cho_solve_mat(l, cols)]


# The Gram form of the edge step.  With Ah = delta^{-1/2} A,
# Bh = delta^{-1/2} B and Z = Lf^{-1} [Ah Bh]:
#   B^T W B = Bh^T Bh - Zb^T Zb,  B^T W A = Bh^T Ah - Zb^T Za,
#   A^T W A = Ah^T Ah - Za^T Za
# (W = delta^{-1/2}(I - F^{-1})delta^{-1/2}, F^{-1} = Lf^{-T} Lf^{-1}), so
# F^{-1}, W and WA are never formed, and the symmetric outputs are computed
# on the upper triangle only.

def _gram_core(Lf, A, B, M, R, Qp, sdi, n, m):
    """Given the child's F Cholesky and the per-row delta^{-1/2}, return
    (Lg, K, Vp).  R and Qp are read symmetrized, so a numerically
    asymmetric Hessian block cannot diverge from the full-matrix
    backends."""
    Ah = [[sdi[i] * A[i][j] for j in range(n)] for i in range(n)]
    Bh = [[sdi[i] * B[i][j] for j in range(m)] for i in range(n)]
    Za = _tri_solve_mat(Lf, Ah, False)
    Zb = _tri_solve_mat(Lf, Bh, False)
    G = [[None] * m for _ in range(m)]
    for i in range(m):
        for j in range(i, m):
            s = R[i][j] if i == j else 0.5 * (R[i][j] + R[j][i])
            for k in range(n):
                s = s + Bh[k][i] * Bh[k][j] - Zb[k][i] * Zb[k][j]
            G[i][j] = G[j][i] = s
    Lg = _chol(G)
    H = [[M[j][i] + _sum([Bh[k][i] * Ah[k][j] - Zb[k][i] * Za[k][j]
                          for k in range(n)])
          for j in range(n)] for i in range(m)]
    Kneg = _cho_solve_mat(Lg, H)
    K = [[-Kneg[i][j] for j in range(n)] for i in range(m)]
    Vp = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i, n):
            s = Qp[i][j] if i == j else 0.5 * (Qp[i][j] + Qp[j][i])
            for k in range(n):
                s = s + Ah[k][i] * Ah[k][j] - Za[k][i] * Za[k][j]
            for k in range(m):
                s = s + K[k][i] * H[k][j]
            Vp[i][j] = Vp[j][i] = s
    return Lg, K, Vp


# ---------------------------------------------------------------------------
# kernels: refs are [stages, rows, BLOCK_B] views of batch-minor arrays
# ---------------------------------------------------------------------------

def _factor_kernel(n, m, T, q_ref, d_ref, a_ref, b_ref, m_ref, r_ref,
                   v_ref, k_ref, g_ref):
    """Backward factorization (reference: lqr.cpp:645-731), carry V's upper
    triangle.  Edge e joins node e (parent) to node e + 1 (child)."""
    tri = [(i, j) for i in range(n) for j in range(i, n)]

    def body(t, vc):
        e = T - 1 - t
        V = [[None] * n for _ in range(n)]
        for (i, j), v in zip(tri, vc):
            V[i][j] = V[j][i] = v
        sd, sdi = _sqrt_delta(_vec(d_ref, e + 1, n))
        one = jnp.ones_like(sd[0])
        F = [[sd[i] * V[i][j] * sd[j] + one if i == j
              else sd[i] * V[i][j] * sd[j] for j in range(n)]
             for i in range(n)]
        Lg, K, Vp = _gram_core(
            _chol(F), _mat(a_ref, e, n, n), _mat(b_ref, e, n, m),
            _mat(m_ref, e, n, m), _mat(r_ref, e, m, m),
            _mat(q_ref, e, n, n), sdi, n, m)
        _store(v_ref, e, _flat(Vp))
        _store(k_ref, e, _flat(K))
        _store(g_ref, e, _flat(Lg))
        return [Vp[i][j] for i, j in tri]

    QT = _mat(q_ref, T, n, n)
    lax.fori_loop(0, T, body, [QT[i][j] if i == j
                               else 0.5 * (QT[i][j] + QT[j][i])
                               for i, j in tri])


def _solve_bwd_kernel(n, m, T, q_ref, r_ref, c_ref, d_ref, f_ref, g_ref,
                      kg_ref, a_ref, b_ref, k_ref, v_ref):
    """Backward vector pass per edge (reference: lqr.cpp:746-795), carry v.

    Uses the child's F Cholesky instead of W:
    W f = delta^{-1/2}(fh - F^{-1} fh) with fh = delta^{-1/2} f."""
    def body(t, v_c):
        e = T - 1 - t
        c_c = _vec(c_ref, e + 1, n)
        delta = _vec(d_ref, e + 1, n)
        B = _mat(b_ref, e, n, m)
        r = _vec(r_ref, e, m)
        _, sdi = _sqrt_delta(delta)
        fh = [sdi[i] * (delta[i] * v_c[i] - c_c[i]) for i in range(n)]
        finv_fh = _cho_solve_vec(_lower(f_ref, e + 1, n), fh)
        g = [v_c[i] - sdi[i] * (fh[i] - finv_fh[i]) for i in range(n)]
        h = [r[i] + _sum([B[k][i] * g[k] for k in range(n)])
             for i in range(m)]
        k_vec = [-x for x in _cho_solve_vec(_lower(g_ref, e, m), h)]
        Atg = _matvec(_transpose(_mat(a_ref, e, n, n)), g)
        Kth = _matvec(_transpose(_mat(kg_ref, e, m, n)), h)
        q_p = _vec(q_ref, e, n)
        v_p = [q_p[i] + Atg[i] + Kth[i] for i in range(n)]
        _store(k_ref, e, k_vec)
        _store(v_ref, e, v_p)
        return v_p

    lax.fori_loop(0, T, body, _vec(q_ref, T, n))


def _solve_fwd_kernel(n, m, T, x0_ref, k_ref, kg_ref, a_ref, b_ref, c_ref,
                      d_ref, v_ref, vm_ref, f_ref, u_ref, x_ref, y_ref):
    """Forward rollout per edge (reference: lqr.cpp:821-870), carry x."""
    def body(e, x_p):
        k_vec = _vec(k_ref, e, m)
        Kx = _matvec(_mat(kg_ref, e, m, n), x_p)
        u = [k_vec[i] + Kx[i] for i in range(m)]
        Ax = _matvec(_mat(a_ref, e, n, n), x_p)
        Bu = _matvec(_mat(b_ref, e, n, m), u)
        c_c = _vec(c_ref, e + 1, n)
        delta = _vec(d_ref, e + 1, n)
        v_c = _vec(v_ref, e + 1, n)
        rhs = [c_c[i] - delta[i] * v_c[i] + Ax[i] + Bu[i] for i in range(n)]
        sd, sdi = _sqrt_delta(delta)
        xs = _cho_solve_vec(_lower(f_ref, e + 1, n),
                            [sdi[i] * rhs[i] for i in range(n)])
        x_c = [sd[i] * xs[i] for i in range(n)]
        Vx = _matvec(_mat(vm_ref, e + 1, n, n), x_c)
        y_c = [v_c[i] + Vx[i] for i in range(n)]
        _store(u_ref, e, u)
        _store(x_ref, e, x_c)
        _store(y_ref, e, y_c)
        return x_c

    lax.fori_loop(0, T, body, [x0_ref[0, i, :] for i in range(n)])


# ---------------------------------------------------------------------------
# wrappers: layout, padding, launch
# ---------------------------------------------------------------------------

def _lanes(x):
    """[batch, stages, *dims] -> [stages, prod(dims), batch]."""
    return jnp.transpose(x.reshape(x.shape[0], x.shape[1], -1), (1, 2, 0))


def _unlanes(x, *dims):
    """[stages, rows, batch] -> [batch, stages, *dims]."""
    return jnp.transpose(x, (2, 0, 1)).reshape(
        (x.shape[2], x.shape[0]) + dims)


def _pad_batch(tree, fillers, pad):
    """Append `pad` inert scenarios, each leaf filled with its filler."""
    if not pad:
        return tree
    return jax.tree.map(
        lambda x, f: jnp.concatenate(
            [x, jnp.broadcast_to(f, (pad,) + x.shape[1:]).astype(x.dtype)]),
        tree, fillers)


def _inert_data(n, m, dtype):
    from .lqr import LQRData
    zn, eye_n, eye_m = jnp.zeros(n, dtype), jnp.eye(n, dtype=dtype), \
        jnp.eye(m, dtype=dtype)
    return LQRData(Q=eye_n, q=zn, c=zn, delta=jnp.ones(n, dtype),
                   A=jnp.zeros((n, n), dtype), B=jnp.zeros((n, m), dtype),
                   M=jnp.zeros((n, m), dtype), R=eye_m,
                   r=jnp.zeros(m, dtype))


def _launch(kernel, name, ins, out_rows, T, block_b, num_warps, interpret):
    """One program per block of `block_b` scenarios; every operand is a
    batch-minor array whose last axis is blocked."""
    Bp = ins[0].shape[-1]
    dtype = ins[0].dtype

    def spec(shape):
        nd = len(shape)
        return pl.BlockSpec(tuple(shape[:-1]) + (block_b,),
                            lambda b: (0,) * (nd - 1) + (b,))

    out_shape = [jax.ShapeDtypeStruct((T, r, Bp), dtype) for r in out_rows]
    return pl.pallas_call(
        kernel,
        grid=(Bp // block_b,),
        in_specs=[spec(x.shape) for x in ins],
        out_specs=[spec(o.shape) for o in out_shape],
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps),
        interpret=interpret,
        name=name,
    )(*ins)


def factor_chain_triton(data, *, block_b=_BLOCK_B, num_warps=_NUM_WARPS,
                        interpret=False):
    """Factor a batch of chains (leading batch axis) with the kernel.
    Returns the same LQRFactorization as the vmapped scan backend."""
    from .lqr import (LQRFactorization, _factor_F, _merge_status,
                      _regularized_W)

    Bt, T = data.A.shape[:2]
    n, m = data.Q.shape[-1], data.R.shape[-1]
    pad = (-Bt) % block_b
    data = _pad_batch(data, _inert_data(n, m, data.Q.dtype), pad)

    ins = [_lanes(x) for x in (data.Q, data.delta, data.A, data.B, data.M,
                               data.R)]
    v_e, k_e, g_e = _launch(
        functools.partial(_factor_kernel, n, m, T), "chain_riccati_factor",
        ins, (n * n, m * n, m * m), T, block_b, num_warps, interpret)

    V = jnp.concatenate([_unlanes(v_e, n, n), data.Q[:, -1:]], axis=1)
    K = _unlanes(k_e, m, n)
    G_chol = _unlanes(g_e, m, m)
    F_chol, sd, sdi, f_status = _factor_F(data.delta, V)
    # edge e's W is its child node's; solver programs never read W on this
    # path (the solve kernels use F_chol), so XLA drops this pass there
    W = _regularized_W(F_chol, sdi)[:, 1:]
    g_diag = jnp.diagonal(G_chol, axis1=-2, axis2=-1)
    g_ok = jnp.all(jnp.isfinite(g_diag) & (g_diag > 0), axis=(-2, -1))
    nan_fail = jnp.any(~jnp.isfinite(V), axis=(1, 2, 3))
    status = _merge_status(
        jnp.max(f_status, axis=-1),
        jnp.where(g_ok & ~nan_fail, FactorStatus.SUCCESS,
                  FactorStatus.G_FACTORIZATION_FAILURE).astype(jnp.int32))
    fact = LQRFactorization(V=V, F_chol=F_chol, sqrt_delta=sd,
                            sqrt_delta_inv=sdi, W=W, K=K, G_chol=G_chol,
                            status=status)
    return jax.tree.map(lambda a: a[:Bt], fact)


def solve_chain_triton(data, fact, *, block_b=_BLOCK_B,
                       num_warps=_NUM_WARPS, interpret=False):
    """Solve a batch of factored chains with the backward and forward
    kernels; the root state is computed between them in XLA."""
    from .lqr import LQRFactorization, LQRSolution, _F_inv_apply

    Bt, T = data.A.shape[:2]
    n, m = data.Q.shape[-1], data.R.shape[-1]
    dtype = data.Q.dtype
    pad = (-Bt) % block_b
    data = _pad_batch(data, _inert_data(n, m, dtype), pad)
    eye_n, ones_n = jnp.eye(n, dtype=dtype), jnp.ones(n, dtype)
    fact = _pad_batch(fact, LQRFactorization(
        V=eye_n, F_chol=jnp.sqrt(2.0) * eye_n, sqrt_delta=ones_n,
        sqrt_delta_inv=ones_n, W=0.5 * eye_n, K=jnp.zeros((m, n), dtype),
        G_chol=jnp.eye(m, dtype=dtype), status=jnp.int32(0)), pad)

    ct, dt, Ft, Kt, At, Bl = (_lanes(x) for x in (
        data.c, data.delta, fact.F_chol, fact.K, data.A, data.B))
    k_e, v_e = _launch(
        functools.partial(_solve_bwd_kernel, n, m, T), "chain_riccati_bwd",
        [_lanes(data.q), _lanes(data.r), ct, dt, Ft, _lanes(fact.G_chol),
         Kt, At, Bl],
        (m, n), T, block_b, num_warps, interpret)
    v = jnp.concatenate([_unlanes(v_e, n), data.q[:, -1:]], axis=1)

    # root state/costate (reference: lqr.cpp:798-819)
    f_root = data.delta[:, 0] * v[:, 0] - data.c[:, 0]
    x_root = -_F_inv_apply(fact.F_chol[:, 0], fact.sqrt_delta[:, 0],
                           fact.sqrt_delta_inv[:, 0], f_root)
    y_root = v[:, 0] + (fact.V[:, 0] @ x_root[..., None])[..., 0]

    u_e, x_e, y_e = _launch(
        functools.partial(_solve_fwd_kernel, n, m, T), "chain_riccati_fwd",
        [_lanes(x_root[:, None]), k_e, Kt, At, Bl, ct, dt, _lanes(v),
         _lanes(fact.V), Ft],
        (m, n, n), T, block_b, num_warps, interpret)

    sol = LQRSolution(
        x=jnp.concatenate([x_root[:, None], _unlanes(x_e, n)], axis=1),
        u=_unlanes(u_e, m),
        y=jnp.concatenate([y_root[:, None], _unlanes(y_e, n)], axis=1))
    return jax.tree.map(lambda a: a[:Bt], sol)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _supports(data) -> bool:
    return (data.Q.dtype == jnp.float32 and data.A.shape[-3] >= 2
            and data.R.shape[-1] >= 1 and data.Q.shape[-1] <= _MAX_N)


def _broadcast_batched(axis_size, in_batched, args):
    def bcast(x, batched):
        return x if batched else jnp.broadcast_to(x, (axis_size,) + x.shape)
    return [jax.tree.map(bcast, a, b) for a, b in zip(args, in_batched)]


def _kernel_or_scan(kernel, scan, *args):
    if not _supports(args[0]):
        return scan(*args)
    return lax.platform_dependent(*args, cuda=kernel, default=scan)


@custom_vmap
def factor_chain_pallas(data):
    """Unbatched call: the sequential scan."""
    from .lqr import _factor_chain
    return _factor_chain(data)


@factor_chain_pallas.def_vmap
def _factor_vmap_rule(axis_size, in_batched, data):
    from .lqr import _factor_chain
    (data_b,) = _broadcast_batched(axis_size, in_batched, [data])
    fact = _kernel_or_scan(factor_chain_triton, jax.vmap(_factor_chain),
                           data_b)
    return fact, jax.tree.map(lambda _: True, fact)


@custom_vmap
def solve_chain_pallas(data, fact):
    """Unbatched call: the sequential scan."""
    from .lqr import _solve_chain
    return _solve_chain(data, fact)


@solve_chain_pallas.def_vmap
def _solve_vmap_rule(axis_size, in_batched, data, fact):
    from .lqr import _solve_chain
    data_b, fact_b = _broadcast_batched(axis_size, in_batched, [data, fact])
    sol = _kernel_or_scan(solve_chain_triton, jax.vmap(_solve_chain),
                          data_b, fact_b)
    return sol, jax.tree.map(lambda _: True, sol)

"""Dual-regularized tree-LQR factor/solve — the flagship compute path.

A batched re-design of the reference's Riccati solver
(reference: sip_optimal_control/lqr.cpp:473-871).  The exact linear system
(reference: tests/lqr_test.cpp:152-186):

  stationarity (node i):  Q_i x_i + sum_{e: parent(e)=i} M_e u_e - y_i
                          + sum_e A_e^T y_child(e) + q_i = 0
  stationarity (edge e):  M_e^T x_par + R_e u_e + B_e^T y_child + r_e = 0
  dynamics     (edge e):  A_e x_par + B_e u_e - x_child
                          - delta_child o y_child + c_child = 0
  root:                  -x_root - delta_root o y_root + c_root = 0

Factorization identities (reference: lqr.cpp:487-549):
  F = I + sqrt(delta) V sqrt(delta)            (Cholesky)
  W = (V^{-1} + delta)^{-1} = delta^{-1/2} (I - F^{-1}) delta^{-1/2}
  (I + delta V)^{-1} b = delta^{1/2} F^{-1} delta^{-1/2} b

Backward pass per edge (reference: lqr.cpp:689-719):
  G = R + B^T W B   (Cholesky), H = M^T + B^T W A, K = -G^{-1} H,
  V_parent += A^T W A + K^T H.

Design: data is stored SoA with a leading node/edge axis ([N, n, n] etc.,
padded to max dims with masks — BASELINE config 2); chains run as a
`lax.scan` over the horizon; general trees run level-synchronously (all
nodes of equal depth processed in one batched step, contributions
scatter-added to parents), giving O(depth) sequential steps instead of the
reference's O(N) node loop.  Scenario batching is a `jax.vmap` over a
leading batch axis of every array.  Statuses are int32 data carried through
the program (no host aborts inside jit).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..types import (Dimensions, FactorStatus, Topology, TopologySchedule,
                     compile_topology)
from .linalg import cho_solve, cholesky_with_ok, ge_solve

# Unrolling the chain scans trades program size for fewer sequential loop
# trips (the per-step bodies are tiny).  Overridable for tuning experiments
# via SOC_SCAN_UNROLL.
import os as _os
_SCAN_UNROLL = int(_os.environ.get("SOC_SCAN_UNROLL", "2"))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LQRData:
    """Stacked tree-LQR problem data (padded to max dims).

    Node-indexed (N = num_nodes): Q [N,n,n], q [N,n], c [N,n], delta [N,n].
    Edge-indexed (E = num_edges): A [E,n,n] (child x parent), B [E,n,m],
    M [E,n,m] (parent-state x control), R [E,m,m], r [E,m].

    Equivalent of LQR::Input's pointer tables (reference: lqr.hpp:76-89) as
    SoA device arrays.
    """

    Q: jax.Array
    q: jax.Array
    c: jax.Array
    delta: jax.Array
    A: jax.Array
    B: jax.Array
    M: jax.Array
    R: jax.Array
    r: jax.Array


class LQRFactorization(NamedTuple):
    """Equivalent of LQR::Workspace's factor products
    (reference: lqr.hpp:109-127)."""

    V: jax.Array               # [N, n, n] cost-to-go
    F_chol: jax.Array          # [N, n, n] Cholesky of I + sqrt(d) V sqrt(d)
    sqrt_delta: jax.Array      # [N, n]
    sqrt_delta_inv: jax.Array  # [N, n]
    W: jax.Array               # [E, n, n]
    K: jax.Array               # [E, m, n] feedback gains
    G_chol: jax.Array          # [E, m, m]
    status: jax.Array          # int32 scalar, FactorStatus


class LQRSolution(NamedTuple):
    """Equivalent of LQR::Output (reference: lqr.hpp:91-107)."""

    x: jax.Array   # [N, n] states
    u: jax.Array   # [E, m] controls
    y: jax.Array   # [N, n] costates


# ---------------------------------------------------------------------------
# per-stage building blocks
# ---------------------------------------------------------------------------

def _factor_F(delta, V):
    """F = I + sqrt(delta) V sqrt(delta), Cholesky + status
    (reference: lqr.cpp:487-509)."""
    delta_ok = jnp.all(delta > 0, axis=-1)
    safe_delta = jnp.where(delta > 0, delta, 1.0)
    sd = jnp.sqrt(safe_delta)
    sdi = 1.0 / sd
    n = V.shape[-1]
    F = sd[..., :, None] * V * sd[..., None, :] + jnp.eye(n, dtype=V.dtype)
    F_chol, chol_ok = cholesky_with_ok(F)
    status = jnp.where(
        delta_ok,
        jnp.where(chol_ok, FactorStatus.SUCCESS,
                  FactorStatus.F_FACTORIZATION_FAILURE),
        FactorStatus.INVALID_DELTA,
    ).astype(jnp.int32)
    return F_chol, sd, sdi, status


def _regularized_W(F_chol, sdi):
    """W = delta^{-1/2} (I - F^{-1}) delta^{-1/2}
    (reference: compute_regularized_W, lqr.cpp:511-529)."""
    n = F_chol.shape[-1]
    F_inv = cho_solve(F_chol, jnp.broadcast_to(
        jnp.eye(n, dtype=F_chol.dtype), F_chol.shape))
    return sdi[..., :, None] * (jnp.eye(n, dtype=F_chol.dtype) - F_inv) \
        * sdi[..., None, :]


def _F_inv_apply(F_chol, sd, sdi, b):
    """(I + delta V)^{-1} b = sqrt(d) F^{-1} (b / sqrt(d))
    (reference: F_inv_mult_vector, lqr.cpp:531-549).  b: [..., n] or
    [..., n, k]."""
    if b.ndim == F_chol.ndim:          # matrix rhs
        return sd[..., :, None] * cho_solve(F_chol, sdi[..., :, None] * b)
    return sd * cho_solve(F_chol, sdi * b)


def _edge_factor(W, A, B, M, R):
    """Backward-pass edge algebra (reference: lqr.cpp:689-719).

    Returns (G_chol, K, V_contrib, ok) where V_contrib = A^T W A + K^T H is
    the parent's cost-to-go increment.
    """
    T = jnp.swapaxes
    BtW = T(B, -1, -2) @ W                       # [m, n_child]
    G = R + BtW @ B                              # [m, m]
    G_chol, ok = cholesky_with_ok(G)
    WA = W @ A                                   # [n_child, n_parent]
    H = T(M, -1, -2) + T(B, -1, -2) @ WA         # [m, n_parent]
    K = -cho_solve(G_chol, H)                    # [m, n_parent]
    V_contrib = T(A, -1, -2) @ WA + T(K, -1, -2) @ H
    return G_chol, K, V_contrib, ok


def _edge_solve_backward(v_child, c_child, delta_child, W, G_chol, K, A, B, r):
    """Backward vector pass per edge (reference: lqr.cpp:746-795).

    Returns (k, v_contrib) with u = k + K x_parent downstream.
    """
    T = jnp.swapaxes
    f = delta_child * v_child - c_child
    g = v_child - (W @ f[..., None])[..., 0]
    h = r + (T(B, -1, -2) @ g[..., None])[..., 0]
    k = -cho_solve(G_chol, h)
    v_contrib = (T(A, -1, -2) @ g[..., None])[..., 0] \
        + (T(K, -1, -2) @ h[..., None])[..., 0]
    return k, v_contrib


def _edge_solve_forward(x_parent, k, K, A, B, c_child, delta_child, v_child,
                        V_child, F_chol_child, sd_child, sdi_child):
    """Forward rollout per edge (reference: lqr.cpp:821-870)."""
    u = k + (K @ x_parent[..., None])[..., 0]
    rhs = (c_child - delta_child * v_child
           + (A @ x_parent[..., None])[..., 0]
           + (B @ u[..., None])[..., 0])
    x_child = _F_inv_apply(F_chol_child, sd_child, sdi_child, rhs)
    y_child = v_child + (V_child @ x_child[..., None])[..., 0]
    return u, x_child, y_child


def _merge_status(first, second):
    """Keep the first non-SUCCESS status in processing order (the reference
    aborts at the first failure; we process everything and report the
    earliest)."""
    return jnp.where(first != FactorStatus.SUCCESS, first, second)


# ---------------------------------------------------------------------------
# chain fast path: lax.scan over the horizon
# ---------------------------------------------------------------------------

def _factor_chain(data: LQRData) -> LQRFactorization:
    T_h = data.A.shape[0]          # horizon (num edges)

    FT_chol, sdT, sdiT, statusT = _factor_F(data.delta[T_h], data.Q[T_h])

    def step(carry, inp):
        F_chol_c, sd_c, sdi_c, status = carry
        Q_i, delta_i, A_i, B_i, M_i, R_i = inp
        W = _regularized_W(F_chol_c, sdi_c)
        G_chol, K, V_contrib, g_ok = _edge_factor(W, A_i, B_i, M_i, R_i)
        V_i = Q_i + V_contrib
        F_chol_i, sd_i, sdi_i, f_status = _factor_F(delta_i, V_i)
        step_status = _merge_status(
            jnp.where(g_ok, FactorStatus.SUCCESS,
                      FactorStatus.G_FACTORIZATION_FAILURE).astype(jnp.int32),
            f_status)
        status = _merge_status(status, step_status)
        carry = (F_chol_i, sd_i, sdi_i, status)
        return carry, (V_i, F_chol_i, sd_i, sdi_i, W, K, G_chol)

    inputs = (data.Q[:T_h], data.delta[:T_h], data.A, data.B, data.M, data.R)
    (_, _, _, status), outs = lax.scan(
        step, (FT_chol, sdT, sdiT, statusT), inputs, reverse=True,
        unroll=_SCAN_UNROLL)
    V_e, F_chol_e, sd_e, sdi_e, W, K, G_chol = outs

    V = jnp.concatenate([V_e, data.Q[T_h][None]], axis=0)
    F_chol = jnp.concatenate([F_chol_e, FT_chol[None]], axis=0)
    sd = jnp.concatenate([sd_e, sdT[None]], axis=0)
    sdi = jnp.concatenate([sdi_e, sdiT[None]], axis=0)
    return LQRFactorization(V=V, F_chol=F_chol, sqrt_delta=sd,
                            sqrt_delta_inv=sdi, W=W, K=K, G_chol=G_chol,
                            status=status)


def _solve_chain(data: LQRData, fact: LQRFactorization) -> LQRSolution:
    T_h = data.A.shape[0]

    def bwd(v_child, inp):
        q_i, r_i, c_c, delta_c, W_i, G_chol_i, K_i, A_i, B_i = inp
        k_i, v_contrib = _edge_solve_backward(
            v_child, c_c, delta_c, W_i, G_chol_i, K_i, A_i, B_i, r_i)
        v_i = q_i + v_contrib
        return v_i, (k_i, v_i)

    inputs = (data.q[:T_h], data.r, data.c[1:], data.delta[1:], fact.W,
              fact.G_chol, fact.K, data.A, data.B)
    _, (k, v_e) = lax.scan(bwd, data.q[T_h], inputs, reverse=True,
                           unroll=_SCAN_UNROLL)
    v = jnp.concatenate([v_e, data.q[T_h][None]], axis=0)

    # Root (reference: lqr.cpp:798-819).
    f_root = data.delta[0] * v[0] - data.c[0]
    x_root = -_F_inv_apply(fact.F_chol[0], fact.sqrt_delta[0],
                           fact.sqrt_delta_inv[0], f_root)
    y_root = v[0] + (fact.V[0] @ x_root[..., None])[..., 0]

    def fwd(x_parent, inp):
        (k_i, K_i, A_i, B_i, c_c, delta_c, v_c, V_c, F_chol_c, sd_c,
         sdi_c) = inp
        u_i, x_c, y_c = _edge_solve_forward(
            x_parent, k_i, K_i, A_i, B_i, c_c, delta_c, v_c, V_c, F_chol_c,
            sd_c, sdi_c)
        return x_c, (u_i, x_c, y_c)

    inputs = (k, fact.K, data.A, data.B, data.c[1:], data.delta[1:], v[1:],
              fact.V[1:], fact.F_chol[1:], fact.sqrt_delta[1:],
              fact.sqrt_delta_inv[1:])
    _, (u, x_tail, y_tail) = lax.scan(fwd, x_root, inputs,
                                      unroll=_SCAN_UNROLL)

    x = jnp.concatenate([x_root[None], x_tail], axis=0)
    y = jnp.concatenate([y_root[None], y_tail], axis=0)
    return LQRSolution(x=x, u=u, y=y)


# ---------------------------------------------------------------------------
# chain parallel-in-time path: associative-scan Riccati (O(log T) depth)
# ---------------------------------------------------------------------------
#
# The sequential backward recursion V_p = Q_p + A^T W A - H^T G^{-1} H with
# W = (V_c^{-1} + delta)^{-1} is, after eliminating the control analytically,
# the linear-fractional map
#
#   V_p = J + Abar^T (I + V_c C)^{-1} V_c Abar,
#   v_p = eta + Abar^T (I + V_c C)^{-1} (v_c + V_c bbar),
#
# with per-edge element (Abar, bbar, C, eta, J):
#   Abar = A - B R^{-1} M^T,     bbar = c_child - B R^{-1} r,
#   C    = delta_child + B R^{-1} B^T   (the dual regularization enters
#          exactly like process noise in the parallel-LQT formulation),
#   eta  = q_parent - M R^{-1} r,  J = Q_parent - M R^{-1} M^T.
#
# Such conditional-value-function elements compose associatively (cf.
# PAPERS.md: "The Parallelization of Riccati Recursion", arXiv 1809.06360,
# and Sarkka & Garcia-Fernandez's parallel LQT), so all V_k come out of one
# `lax.associative_scan` (suffix products, O(log T) sequential depth), after
# which the stagewise factor products (F, W, G, K) are computed for ALL
# edges in a single batched step.  The solve's backward (v) and forward (x)
# passes are affine recursions, parallelized the same way.
#
# Requirement: R must be SPD stage-by-stage (slightly stronger than the
# sequential path's G = R + B^T W B; always true for the IPM's condensed
# R_mod).  The sequential path remains the default and the fallback.

def _assoc_prefix_scan(fn, xs):
    """Inclusive prefix scan out[i] = x[0] • ... • x[i] by Hillis-Steele
    recursive doubling (log2(T) rounds of contiguous slice + combine +
    concat).  `fn(left, right)` composes the product of an earlier
    contiguous range with the adjacent later range.

    Replaces `lax.associative_scan`: jax 0.9.0's XLA:CPU lowering of
    associative_scan (strided odd/even interleave) MISCOMPILES when the
    scan's consumers are fused — observed as wrong solve results and heap
    corruption (`free(): invalid next size`) depending on which outputs
    stay live.  This formulation uses only contiguous slicing and
    concatenation, which lowers cleanly everywhere; same O(log T)
    sequential depth (O(T log T) combine work — the combines are tiny
    matrix products, fully batched)."""
    n = jax.tree.leaves(xs)[0].shape[0]
    out = xs
    d = 1
    while d < n:
        left = jax.tree.map(lambda a: a[:-d], out)
        right = jax.tree.map(lambda a: a[d:], out)
        comb = fn(left, right)
        out = jax.tree.map(
            lambda a, c: jnp.concatenate([a[:d], c], axis=0), out, comb)
        d *= 2
    return out


def _assoc_suffix_scan(fn, xs):
    """Inclusive suffix scan out[i] = x[i] • ... • x[T] (same `fn(left,
    right)` convention), via the prefix scan on the flipped sequence."""
    rev = jax.tree.map(lambda a: jnp.flip(a, axis=0), xs)
    out = _assoc_prefix_scan(lambda acc, new: fn(new, acc), rev)
    return jax.tree.map(lambda a: jnp.flip(a, axis=0), out)


class _QuadElem(NamedTuple):
    A: jax.Array    # [n, n]
    b: jax.Array    # [n]
    C: jax.Array    # [n, n]
    eta: jax.Array  # [n]
    J: jax.Array    # [n, n]


def _combine_elems(left: _QuadElem, right: _QuadElem) -> _QuadElem:
    """Associative composition: `left` is closer to the root.  Verified
    against direct Schur elimination of the middle state in the tests."""
    n = left.A.shape[-1]
    eye = jnp.eye(n, dtype=left.A.dtype)
    # (I + C_L J_R)^{-1} via LU; shared for several products
    ic = ge_solve(eye + left.C @ right.J,
                          jnp.concatenate(
                              [left.A, left.C,
                               (left.b - (left.C @ right.eta[..., None])
                                [..., 0])[..., None]], axis=-1))
    iA = ic[..., :n]
    iC = ic[..., n:2 * n]
    ib = ic[..., 2 * n]
    # (I + J_R C_L)^{-1} (eta_R + J_R b_L) and ... J_R A_L
    jc = ge_solve(
        eye + right.J @ left.C,
        jnp.concatenate([(right.eta + (right.J @ left.b[..., None])
                          [..., 0])[..., None],
                         right.J @ left.A], axis=-1))
    return _QuadElem(
        A=right.A @ iA,
        b=(right.A @ ib[..., None])[..., 0] + right.b,
        C=right.A @ iC @ jnp.swapaxes(right.A, -1, -2) + right.C,
        eta=(jnp.swapaxes(left.A, -1, -2)
             @ jc[..., 0][..., None])[..., 0] + left.eta,
        J=jnp.swapaxes(left.A, -1, -2) @ jc[..., 1:] + left.J,
    )


def _chain_elements(data: LQRData):
    """Per-edge elements + the terminal element carrying (Q_T, q_T).
    Returns (elems stacked [T+1, ...], R_chol [T, m, m], ok)."""
    T_h = data.A.shape[0]
    n = data.Q.shape[-1]
    R_chol, r_ok = cholesky_with_ok(data.R)
    Rinv_Mt = cho_solve(R_chol, jnp.swapaxes(data.M, -1, -2))  # [T, m, n]
    Rinv_Bt = cho_solve(R_chol, jnp.swapaxes(data.B, -1, -2))  # [T, m, n]
    Rinv_r = cho_solve(R_chol, data.r)                         # [T, m]
    Abar = data.A - data.B @ Rinv_Mt
    bbar = data.c[1:] - (data.B @ Rinv_r[..., None])[..., 0]
    C = _diag_embed_jnp(data.delta[1:]) + data.B @ Rinv_Bt
    eta = data.q[:T_h] - (data.M @ Rinv_r[..., None])[..., 0]
    J = data.Q[:T_h] - data.M @ Rinv_Mt

    zero_mat = jnp.zeros((1, n, n), data.Q.dtype)
    zero_vec = jnp.zeros((1, n), data.Q.dtype)
    elems = _QuadElem(
        A=jnp.concatenate([Abar, zero_mat], axis=0),
        b=jnp.concatenate([bbar, zero_vec], axis=0),
        C=jnp.concatenate([C, zero_mat], axis=0),
        eta=jnp.concatenate([eta, data.q[T_h][None]], axis=0),
        J=jnp.concatenate([J, data.Q[T_h][None]], axis=0),
    )
    return elems, R_chol, jnp.all(r_ok)


def _diag_embed_jnp(v):
    return jnp.zeros(v.shape + (v.shape[-1],), v.dtype) \
        .at[..., jnp.arange(v.shape[-1]), jnp.arange(v.shape[-1])].set(v)


def _factor_chain_assoc(data: LQRData) -> LQRFactorization:
    """Associative-scan factorization; produces the same LQRFactorization
    as the sequential path (so either solve path consumes it)."""
    elems, _, r_ok = _chain_elements(data)
    suffix = _assoc_suffix_scan(_combine_elems, elems)
    V = suffix.J                     # [T+1, n, n]; V[k] = cost-to-go at k

    F_chol, sd, sdi, f_status = jax.vmap(_factor_F)(data.delta, V)
    W = jax.vmap(_regularized_W)(F_chol[1:], sdi[1:])
    G_chol, K, _, g_ok = jax.vmap(_edge_factor)(
        W, data.A, data.B, data.M, data.R)

    # NaNs from a singular (I + C J) combine count as F failures.
    nan_fail = jnp.any(jnp.isnan(V))
    status = _merge_status(
        jnp.where(r_ok, FactorStatus.SUCCESS,
                  FactorStatus.G_FACTORIZATION_FAILURE).astype(jnp.int32),
        _merge_status(
            jnp.where(nan_fail, FactorStatus.F_FACTORIZATION_FAILURE,
                      FactorStatus.SUCCESS).astype(jnp.int32),
            _merge_status(
                jnp.max(f_status),
                jnp.max(jnp.where(
                    g_ok, FactorStatus.SUCCESS,
                    FactorStatus.G_FACTORIZATION_FAILURE).astype(jnp.int32)))))
    return LQRFactorization(V=V, F_chol=F_chol, sqrt_delta=sd,
                            sqrt_delta_inv=sdi, W=W, K=K, G_chol=G_chol,
                            status=status)


class _AffineElem(NamedTuple):
    T: jax.Array   # [n, n]
    o: jax.Array   # [n]


def _solve_chain_assoc(data: LQRData, fact: LQRFactorization) -> LQRSolution:
    """Parallel-in-time solve: affine suffix scan for the costate-gradient
    v, batched gain application, affine prefix scan for the rollout."""
    T_h = data.A.shape[0]
    n = data.Q.shape[-1]
    dtype = data.Q.dtype

    # Backward: v_p = eta_tilde + Tmat v_c, composed as suffix products.
    elems, _, _ = _chain_elements(data)
    Vc = fact.V[1:]
    eye = jnp.eye(n, dtype=dtype)
    # Tmat = Abar^T (I + V_c C)^{-1}, built by solving the transposed
    # system; eta_tilde = eta + Tmat (V_c bbar).
    Tmat = jnp.swapaxes(ge_solve(
        jnp.swapaxes(eye + Vc @ elems.C[:T_h], -1, -2), elems.A[:T_h]),
        -1, -2)
    eta_t = elems.eta[:T_h] + (Tmat @ (Vc @ elems.b[:T_h][..., None]))[..., 0]
    aff = _AffineElem(
        T=jnp.concatenate([Tmat, jnp.zeros((1, n, n), dtype)], axis=0),
        o=jnp.concatenate([eta_t, elems.eta[T_h][None]], axis=0))

    def comb_bwd(left: _AffineElem, right: _AffineElem) -> _AffineElem:
        # v_p = o_L + T_L v_c: apply the left (earlier) map to the composed
        # right suffix: T_L T_R, T_L o_R + o_L.
        return _AffineElem(T=left.T @ right.T,
                           o=(left.T @ right.o[..., None])[..., 0] + left.o)

    v = _assoc_suffix_scan(comb_bwd, aff).o                    # [T+1, n]

    # Per-edge gains on the RHS (all edges batched; reference semantics of
    # _edge_solve_backward but with v already known).
    f = data.delta[1:] * v[1:] - data.c[1:]
    g = v[1:] - (fact.W @ f[..., None])[..., 0]
    h = data.r + (jnp.swapaxes(data.B, -1, -2) @ g[..., None])[..., 0]
    k = -jax.vmap(cho_solve)(fact.G_chol, h)

    # Root state.
    f_root = data.delta[0] * v[0] - data.c[0]
    x_root = -_F_inv_apply(fact.F_chol[0], fact.sqrt_delta[0],
                           fact.sqrt_delta_inv[0], f_root)

    # Forward rollout as affine prefix scan: x_child = E x_par + e with
    # E = Phi (A + B K), e = Phi (B k + c - delta v), Phi = (I+delta V)^{-1}.
    ABK = data.A + data.B @ fact.K
    rhs_const = ((data.B @ k[..., None])[..., 0] + data.c[1:]
                 - data.delta[1:] * v[1:])
    E = jax.vmap(_F_inv_apply)(fact.F_chol[1:], fact.sqrt_delta[1:],
                               fact.sqrt_delta_inv[1:], ABK)
    e0 = jax.vmap(_F_inv_apply)(fact.F_chol[1:], fact.sqrt_delta[1:],
                                fact.sqrt_delta_inv[1:], rhs_const)
    aff_f = _AffineElem(T=E, o=e0)

    def comb_fwd(left: _AffineElem, right: _AffineElem) -> _AffineElem:
        # x_{i+1} = T_R (T_L x + o_L) + o_R: compose later-on-earlier.
        return _AffineElem(T=right.T @ left.T,
                           o=(right.T @ left.o[..., None])[..., 0] + right.o)

    pre = _assoc_prefix_scan(comb_fwd, aff_f)
    x_tail = (pre.T @ x_root[..., None])[..., 0] + pre.o      # [T, n]
    x = jnp.concatenate([x_root[None], x_tail], axis=0)
    u = k + (fact.K @ x[:T_h][..., None])[..., 0]
    y = v + (fact.V @ x[..., None])[..., 0]
    return LQRSolution(x=x, u=u, y=y)


# ---------------------------------------------------------------------------
# general trees: level-synchronous recursion
# ---------------------------------------------------------------------------

def _factor_tree(data: LQRData, sched: TopologySchedule) -> LQRFactorization:
    N = data.Q.shape[0]
    E = data.A.shape[0]
    n = data.Q.shape[-1]
    m = data.R.shape[-1]
    dtype = data.Q.dtype

    V = data.Q
    F_chol = jnp.zeros((N, n, n), dtype)
    sd = jnp.zeros((N, n), dtype)
    sdi = jnp.zeros((N, n), dtype)
    W = jnp.zeros((E, n, n), dtype)
    K = jnp.zeros((E, m, n), dtype)
    G_chol = jnp.zeros((E, m, m), dtype)
    status = jnp.int32(FactorStatus.SUCCESS)

    # Deepest level first; within a level everything is batched.  The status
    # ordering follows level order (deepest first), which matches the
    # reference's postorder for single-failure cases.
    for d in range(sched.num_levels - 1, -1, -1):
        nodes = sched.levels_nodes[d]
        Fd, sdd, sdid, st = _factor_F(data.delta[nodes], V[nodes])
        F_chol = F_chol.at[nodes].set(Fd)
        sd = sd.at[nodes].set(sdd)
        sdi = sdi.at[nodes].set(sdid)
        status = _merge_status(status, jnp.max(st))
        if d > 0:
            edges = sched.levels_edges[d]
            parents = sched.parent_node[nodes]
            Wd = _regularized_W(Fd, sdid)
            Gd, Kd, V_contrib, g_ok = _edge_factor(
                Wd, data.A[edges], data.B[edges], data.M[edges],
                data.R[edges])
            W = W.at[edges].set(Wd)
            K = K.at[edges].set(Kd)
            G_chol = G_chol.at[edges].set(Gd)
            status = _merge_status(status, jnp.max(jnp.where(
                g_ok, FactorStatus.SUCCESS,
                FactorStatus.G_FACTORIZATION_FAILURE).astype(jnp.int32)))
            V = V.at[parents].add(V_contrib)

    return LQRFactorization(V=V, F_chol=F_chol, sqrt_delta=sd,
                            sqrt_delta_inv=sdi, W=W, K=K, G_chol=G_chol,
                            status=status)


def _solve_tree(data: LQRData, fact: LQRFactorization,
                sched: TopologySchedule) -> LQRSolution:
    N = data.Q.shape[0]
    E = data.A.shape[0]
    n = data.Q.shape[-1]
    m = data.R.shape[-1]
    dtype = data.Q.dtype

    v = data.q
    k = jnp.zeros((E, m), dtype)
    for d in range(sched.num_levels - 1, 0, -1):
        nodes = sched.levels_nodes[d]          # children at this depth
        edges = sched.levels_edges[d]
        parents = sched.parent_node[nodes]
        kd, v_contrib = _edge_solve_backward(
            v[nodes], data.c[nodes], data.delta[nodes], fact.W[edges],
            fact.G_chol[edges], fact.K[edges], data.A[edges], data.B[edges],
            data.r[edges])
        k = k.at[edges].set(kd)
        v = v.at[parents].add(v_contrib)

    root = int(sched.preorder[0])
    x = jnp.zeros((N, n), dtype)
    y = jnp.zeros((N, n), dtype)
    u = jnp.zeros((E, m), dtype)

    f_root = data.delta[root] * v[root] - data.c[root]
    x_root = -_F_inv_apply(fact.F_chol[root], fact.sqrt_delta[root],
                           fact.sqrt_delta_inv[root], f_root)
    y_root = v[root] + (fact.V[root] @ x_root[..., None])[..., 0]
    x = x.at[root].set(x_root)
    y = y.at[root].set(y_root)

    for d in range(1, sched.num_levels):
        nodes = sched.levels_nodes[d]
        edges = sched.levels_edges[d]
        parents = sched.parent_node[nodes]
        ud, x_c, y_c = _edge_solve_forward(
            x[parents], k[edges], fact.K[edges], data.A[edges], data.B[edges],
            data.c[nodes], data.delta[nodes], v[nodes], fact.V[nodes],
            fact.F_chol[nodes], fact.sqrt_delta[nodes],
            fact.sqrt_delta_inv[nodes])
        u = u.at[edges].set(ud)
        x = x.at[nodes].set(x_c)
        y = y.at[nodes].set(y_c)

    return LQRSolution(x=x, u=u, y=y)


# ---------------------------------------------------------------------------
# deep trees: lax.scan over padded level schedules
#
# The unrolled level loop above emits one program level per tree depth —
# right for shallow robust-MPC trees, but a depth-D path tree (the
# reference benchmarks heterogeneous_path at T=63,
# reference: lqr_benchmark.cpp:209-271) would unroll D levels.  This
# backend pads every level to the widest one and runs a single traced body
# under lax.scan: O(1) program size at any depth.  Work per level is
# max_level_width, so it is chosen automatically only when the padding
# waste is bounded (deep, narrow trees); wide shallow trees keep the
# unrolled loop.
# ---------------------------------------------------------------------------

def _padded_level_schedule(sched: TopologySchedule):
    """Static [L, W] level index arrays.  Padding rows use index N (nodes /
    parents) or E (edges): gathers are clipped, scatters use mode='drop',
    so padded lanes compute garbage that never lands anywhere."""
    L, W = sched.num_levels, sched.max_level_width
    N = len(sched.depth)
    E = len(sched.child_edges)
    nodes = np.full((L, W), N, np.int32)
    edges = np.full((L, W), E, np.int32)
    parents = np.full((L, W), N, np.int32)
    valid = np.zeros((L, W), bool)
    for d in range(L):
        ln = np.asarray(sched.levels_nodes[d], np.int32)
        w = len(ln)
        nodes[d, :w] = ln
        valid[d, :w] = True
        if d > 0:
            # levels_edges[d][i] is the edge into levels_nodes[d][i]
            edges[d, :w] = np.asarray(sched.levels_edges[d], np.int32)
            parents[d, :w] = sched.parent_node[ln]
    return nodes, edges, parents, valid


def use_level_scan(sched: TopologySchedule) -> bool:
    """Heuristic: scan when the tree is deep and the per-level padding waste
    is bounded (e.g. path-shaped trees).  Wide shallow trees (scenario
    fans, binary trees) keep the unrolled loop, whose total work is exactly
    the node count.

    Escape hatch: SOC_LEVEL_SCAN=0/1 overrides the heuristic (measurement
    and tuning aid; tests pin both backends' parity on shapes straddling
    the threshold)."""
    import os
    env = os.environ.get("SOC_LEVEL_SCAN")
    if env in ("0", "1"):
        return env == "1"
    L, W = sched.num_levels, sched.max_level_width
    N = len(sched.depth)
    # L > 8: the scenario-fan robust-MPC tree (L=14, W=4) takes the scan;
    # depth-<=4 fans/binary trees keep the unrolled loop
    return L > 8 and L * W <= 4 * max(N, 1)


def _factor_tree_scan(data: LQRData,
                      sched: TopologySchedule) -> LQRFactorization:
    N = data.Q.shape[0]
    E = data.A.shape[0]
    n = data.Q.shape[-1]
    m = data.R.shape[-1]
    dtype = data.Q.dtype
    nodes_p, edges_p, parents_p, valid_p = _padded_level_schedule(sched)
    # deepest level first
    xs = (jnp.asarray(nodes_p[::-1]), jnp.asarray(edges_p[::-1]),
          jnp.asarray(parents_p[::-1]), jnp.asarray(valid_p[::-1]))

    init = (data.Q,                                   # V
            jnp.zeros((N, n, n), dtype),              # F_chol
            jnp.zeros((N, n), dtype),                 # sd
            jnp.zeros((N, n), dtype),                 # sdi
            jnp.zeros((E, n, n), dtype),              # W
            jnp.zeros((E, m, n), dtype),              # K
            jnp.zeros((E, m, m), dtype),              # G_chol
            jnp.int32(FactorStatus.SUCCESS))

    def step(carry, inp):
        V, F_chol, sd, sdi, W, K, G_chol, status = carry
        nodes, edges, parents, valid = inp
        ng = jnp.minimum(nodes, N - 1)
        eg = jnp.minimum(edges, E - 1)
        Fd, sdd, sdid, st = _factor_F(data.delta[ng], V[ng])
        F_chol = F_chol.at[nodes].set(Fd, mode="drop")
        sd = sd.at[nodes].set(sdd, mode="drop")
        sdi = sdi.at[nodes].set(sdid, mode="drop")
        st = jnp.where(valid, st, jnp.int32(FactorStatus.SUCCESS))
        status = _merge_status(status, jnp.max(st))
        # edge algebra (level 0 rows are fully padded and drop everywhere)
        Wd = _regularized_W(Fd, sdid)
        Gd, Kd, V_contrib, g_ok = _edge_factor(
            Wd, data.A[eg], data.B[eg], data.M[eg], data.R[eg])
        W = W.at[edges].set(Wd, mode="drop")
        K = K.at[edges].set(Kd, mode="drop")
        G_chol = G_chol.at[edges].set(Gd, mode="drop")
        edge_valid = valid & (edges < E)
        g_st = jnp.where(
            edge_valid & ~g_ok,
            jnp.int32(FactorStatus.G_FACTORIZATION_FAILURE),
            jnp.int32(FactorStatus.SUCCESS))
        status = _merge_status(status, jnp.max(g_st))
        V_contrib = jnp.where(edge_valid[:, None, None], V_contrib, 0.0)
        V = V.at[parents].add(V_contrib, mode="drop")
        return (V, F_chol, sd, sdi, W, K, G_chol, status), None

    (V, F_chol, sd, sdi, W, K, G_chol, status), _ = lax.scan(
        step, init, xs)
    return LQRFactorization(V=V, F_chol=F_chol, sqrt_delta=sd,
                            sqrt_delta_inv=sdi, W=W, K=K, G_chol=G_chol,
                            status=status)


def _solve_tree_scan(data: LQRData, fact: LQRFactorization,
                     sched: TopologySchedule) -> LQRSolution:
    N = data.Q.shape[0]
    E = data.A.shape[0]
    n = data.Q.shape[-1]
    m = data.R.shape[-1]
    dtype = data.Q.dtype
    nodes_p, edges_p, parents_p, valid_p = _padded_level_schedule(sched)
    nodes_j, edges_j, parents_j, valid_j = (
        jnp.asarray(nodes_p), jnp.asarray(edges_p),
        jnp.asarray(parents_p), jnp.asarray(valid_p))

    def bwd(carry, inp):
        v, k = carry
        nodes, edges, parents, valid = inp
        ng = jnp.minimum(nodes, N - 1)
        eg = jnp.minimum(edges, E - 1)
        kd, v_contrib = _edge_solve_backward(
            v[ng], data.c[ng], data.delta[ng], fact.W[eg],
            fact.G_chol[eg], fact.K[eg], data.A[eg], data.B[eg],
            data.r[eg])
        k = k.at[edges].set(kd, mode="drop")
        edge_valid = valid & (edges < E)
        v_contrib = jnp.where(edge_valid[:, None], v_contrib, 0.0)
        v = v.at[parents].add(v_contrib, mode="drop")
        return (v, k), None

    (v, k), _ = lax.scan(
        bwd, (data.q, jnp.zeros((E, m), dtype)),
        (nodes_j[::-1], edges_j[::-1], parents_j[::-1], valid_j[::-1]))

    root = int(sched.preorder[0])
    x = jnp.zeros((N, n), dtype)
    y = jnp.zeros((N, n), dtype)
    u = jnp.zeros((E, m), dtype)
    f_root = data.delta[root] * v[root] - data.c[root]
    x_root = -_F_inv_apply(fact.F_chol[root], fact.sqrt_delta[root],
                           fact.sqrt_delta_inv[root], f_root)
    y_root = v[root] + (fact.V[root] @ x_root[..., None])[..., 0]
    x = x.at[root].set(x_root)
    y = y.at[root].set(y_root)

    def fwd(carry, inp):
        x, y, u = carry
        nodes, edges, parents, valid = inp
        ng = jnp.minimum(nodes, N - 1)
        eg = jnp.minimum(edges, E - 1)
        pg = jnp.minimum(parents, N - 1)
        ud, x_c, y_c = _edge_solve_forward(
            x[pg], k[eg], fact.K[eg], data.A[eg], data.B[eg],
            data.c[ng], data.delta[ng], v[ng], fact.V[ng],
            fact.F_chol[ng], fact.sqrt_delta[ng], fact.sqrt_delta_inv[ng])
        u = u.at[edges].set(ud, mode="drop")
        x = x.at[nodes].set(x_c, mode="drop")
        y = y.at[nodes].set(y_c, mode="drop")
        return (x, y, u), None

    # forward order, skipping level 0 (the root, handled above)
    (x, y, u), _ = lax.scan(
        fwd, (x, y, u),
        (nodes_j[1:], edges_j[1:], parents_j[1:], valid_j[1:]))
    return LQRSolution(x=x, u=u, y=y)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def lqr_factor(data: LQRData, sched: TopologySchedule,
               backend: str = "scan") -> LQRFactorization:
    """Factor the dual-regularized tree-LQR KKT system.

    Equivalent of LQR::factor_with_status (reference: lqr.cpp:645-731), with
    the status returned as int32 data in ``fact.status``.

    ``backend`` selects the chain implementation:
      - "scan":  sequential `lax.scan` (default)
      - "assoc": associative-scan Riccati, O(log T) sequential depth — the
        long-horizon / low-latency path; additionally requires SPD R_e
      - "pallas": Pallas (Triton) kernels that own the horizon loop, for
        float32 scenario batches lowered for CUDA; the scan elsewhere
        (see ops/pallas_riccati.py)
    Trees use the level-synchronous recursion: unrolled per level for
    shallow trees, a lax.scan over padded level schedules for deep narrow
    ones (`use_level_scan`), keeping program size O(1) in depth.
    All backends produce the same LQRFactorization products.
    """
    with jax.named_scope("riccati"):
        return _lqr_factor(data, sched, backend)


def _lqr_factor(data, sched, backend):
    if sched.topology.is_chain:
        if backend == "assoc":
            return _factor_chain_assoc(data)
        if backend == "pallas":
            from .pallas_riccati import factor_chain_pallas
            return factor_chain_pallas(data)
        return _factor_chain(data)
    if use_level_scan(sched):
        return _factor_tree_scan(data, sched)
    return _factor_tree(data, sched)


def lqr_solve(data: LQRData, fact: LQRFactorization,
              sched: TopologySchedule,
              backend: str = "scan") -> LQRSolution:
    """Solve given a factorization (reference: LQR::solve, lqr.cpp:735-871).

    Any solve backend consumes any backend's factorization (same
    products)."""
    with jax.named_scope("riccati"):
        return _lqr_solve(data, fact, sched, backend)


def _lqr_solve(data, fact, sched, backend):
    if sched.topology.is_chain:
        if backend == "assoc":
            return _solve_chain_assoc(data, fact)
        if backend == "pallas":
            from .pallas_riccati import solve_chain_pallas
            return solve_chain_pallas(data, fact)
        return _solve_chain(data, fact)
    if use_level_scan(sched):
        return _solve_tree_scan(data, fact, sched)
    return _solve_tree(data, fact, sched)


def lqr_factor_solve(data: LQRData, sched: TopologySchedule,
                     backend: str = "scan"
                     ) -> Tuple[LQRSolution, jax.Array]:
    fact = lqr_factor(data, sched, backend)
    sol = lqr_solve(data, fact, sched, backend)
    return sol, fact.status


# ---------------------------------------------------------------------------
# padding / masking for variable dimensions (BASELINE config 2)
# ---------------------------------------------------------------------------

def dimension_masks(dims: Dimensions):
    """Boolean masks over padded state/control axes.

    Returns (state_mask [N, n_max], control_mask [E, m_max]) as NumPy; these
    are trace-time constants.
    """
    n_max = max(dims.max_state_dim, 1)
    m_max = max(dims.max_control_dim, 1)
    state_mask = np.zeros((dims.num_nodes, n_max), dtype=bool)
    for i, d in enumerate(dims.state_dims):
        state_mask[i, :d] = True
    control_mask = np.zeros((dims.num_edges, m_max), dtype=bool)
    for e, d in enumerate(dims.control_dims):
        control_mask[e, :d] = True
    return state_mask, control_mask


def pad_lqr_data(data: LQRData, dims: Dimensions,
                 sched: TopologySchedule) -> LQRData:
    """Make padded entries inert so the recursion is exact on the real dims.

    Padding plan: dead state/control entries get unit diagonal in Q and R,
    unit delta, and zeros everywhere else.  Dead rows/columns of A, B, M, q,
    r, c vanish, so dead solution entries are exactly zero and live entries
    match the unpadded problem (the C++ reference instead uses per-stage
    dynamic sizes, lqr.cpp:653-731).
    """
    state_mask, control_mask = dimension_masks(dims)
    child = np.asarray(sched.topology.edge_children)
    parent = np.asarray(sched.topology.edge_parents)
    sm = jnp.asarray(state_mask, dtype=data.Q.dtype)         # [N, n]
    cm = jnp.asarray(control_mask, dtype=data.Q.dtype)       # [E, m]
    sm_child = sm[child]
    sm_parent = sm[parent]
    eye_n = jnp.eye(data.Q.shape[-1], dtype=data.Q.dtype)
    eye_m = jnp.eye(data.R.shape[-1], dtype=data.Q.dtype)

    def mask2(mask_r, mask_c, a, unit_diag):
        out = a * mask_r[..., :, None] * mask_c[..., None, :]
        if unit_diag:
            dead = (1.0 - mask_r)[..., :, None] * \
                (1.0 - mask_c)[..., None, :]
            out = out + dead * (eye_n if a.shape[-1] == eye_n.shape[0]
                                and a.shape[-2] == eye_n.shape[0] else eye_m)
        return out

    return LQRData(
        Q=mask2(sm, sm, data.Q, True),
        q=data.q * sm,
        c=data.c * sm,
        delta=data.delta * sm + (1.0 - sm),
        A=mask2(sm_child, sm_parent, data.A, False),
        B=mask2(sm_child, cm, data.B, False),
        M=mask2(sm_parent, cm, data.M, False),
        R=mask2(cm, cm, data.R, True),
        r=data.r * cm,
    )


def lqr_residual_norm(data: LQRData, sol: LQRSolution,
                      sched: TopologySchedule) -> jax.Array:
    """KKT residual of the regularized system — the test oracle
    (reference: tests/lqr_test.cpp:152-186).  Works for any tree."""
    child = jnp.asarray(sched.topology.edge_children)
    parent = jnp.asarray(sched.topology.edge_parents)
    root = sched.topology.root
    T = jnp.swapaxes

    x_par = sol.x[parent]                       # [E, n]
    y_child = sol.y[child]

    # node stationarity: Q x - y + q + scatter(M u) + scatter(A^T y_child)
    r_node = (data.Q @ sol.x[..., None])[..., 0] - sol.y + data.q
    Mu = (data.M @ sol.u[..., None])[..., 0]          # [E, n] into parent
    Aty = (T(data.A, -1, -2) @ y_child[..., None])[..., 0]
    r_node = r_node.at[parent].add(Mu + Aty)

    r_edge = ((T(data.M, -1, -2) @ x_par[..., None])[..., 0]
              + (data.R @ sol.u[..., None])[..., 0]
              + (T(data.B, -1, -2) @ y_child[..., None])[..., 0] + data.r)

    r_dyn = ((data.A @ x_par[..., None])[..., 0]
             + (data.B @ sol.u[..., None])[..., 0]
             - sol.x[child] - data.delta[child] * y_child + data.c[child])

    r_root = -sol.x[root] - data.delta[root] * sol.y[root] + data.c[root]

    sq = (jnp.sum(r_node ** 2) + jnp.sum(r_edge ** 2) + jnp.sum(r_dyn ** 2)
          + jnp.sum(r_root ** 2))
    return jnp.sqrt(sq)

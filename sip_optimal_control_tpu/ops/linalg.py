"""Small dense linear-algebra primitives for the Riccati recursion.

Batched equivalents of the reference's Eigen LLT + triangular solves
(reference: sip_optimal_control/lqr.cpp:473-549).  Stage matrices are tiny
(n, m <= ~32) with *static* shapes, and throughput comes from batching
thousands of scenarios — so instead of generic LAPACK-style kernels (slow to
compile, and one tiny problem per call) we fully unroll the factorizations
at trace time.  Every unrolled op is an elementwise op over the batch,
which XLA fuses: the classic "many small problems on SIMD" layout.

Failure is reported as data (bool), never as an exception — a batched solver
cannot abort on one bad scenario.  Non-PD inputs yield NaNs in the factor,
detected from the diagonal like Eigen's llt.info() check.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

# Above this size the unrolled graphs get large; fall back to lax.linalg.
_UNROLL_LIMIT = 24


def _chol_unrolled(a: jax.Array) -> jax.Array:
    """Unrolled lower Cholesky over the last two (static) dims."""
    n = a.shape[-1]
    col = [[None] * n for _ in range(n)]   # col[j][i] = L[i, j], i >= j
    for j in range(n):
        s = a[..., j, j]
        for k in range(j):
            s = s - col[k][j] * col[k][j]
        d = jnp.sqrt(s)
        col[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = a[..., i, j]
            for k in range(j):
                s = s - col[k][i] * col[k][j]
            col[j][i] = s * inv_d
    zero = jnp.zeros_like(a[..., 0, 0])
    rows = [jnp.stack([col[j][i] if j <= i else zero for j in range(n)],
                      axis=-1) for i in range(n)]
    return jnp.stack(rows, axis=-2)


def _tri_solve_unrolled(l: jax.Array, b: jax.Array,
                        transpose: bool) -> jax.Array:
    """Solve L x = b (or L^T x = b) by unrolled substitution.

    b: [..., n] or [..., n, k]; L lower triangular [..., n, n].
    """
    n = l.shape[-1]
    matrix_rhs = b.ndim == l.ndim

    def lij(i, j):
        v = l[..., i, j]
        return v[..., None] if matrix_rhs else v

    x = [None] * n
    order = range(n - 1, -1, -1) if transpose else range(n)
    for i in order:
        s = b[..., i, :] if matrix_rhs else b[..., i]
        ks = range(i + 1, n) if transpose else range(i)
        for k in ks:
            coeff = lij(k, i) if transpose else lij(i, k)
            s = s - coeff * x[k]
        x[i] = s / lij(i, i)
    return jnp.stack(x, axis=-2 if matrix_rhs else -1)


def cholesky_with_ok(a: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Lower Cholesky factor plus a validity flag (cf. Eigen::LLT info(),
    reference: lqr.cpp:505-508, 697-700)."""
    n = a.shape[-1]
    if n <= _UNROLL_LIMIT:
        l = _chol_unrolled(a)
    else:
        l = jnp.linalg.cholesky(a)
    diag = jnp.diagonal(l, axis1=-2, axis2=-1)
    ok = jnp.all(jnp.isfinite(diag) & (diag > 0), axis=-1)
    return l, ok


def tri_solve(l: jax.Array, b: jax.Array, transpose: bool = False):
    n = l.shape[-1]
    if n <= _UNROLL_LIMIT:
        return _tri_solve_unrolled(l, b, transpose)
    vec = b.ndim == l.ndim - 1
    if vec:
        b = b[..., None]
    x = lax.linalg.triangular_solve(l, b, left_side=True, lower=True,
                                    transpose_a=transpose)
    return x[..., 0] if vec else x


def cho_solve(l: jax.Array, b: jax.Array) -> jax.Array:
    """Solve (L L^T) x = b given lower factor L.  b: [..., n] or [..., n, k]."""
    return tri_solve(l, tri_solve(l, b, transpose=False), transpose=True)


def _ge_solve_unrolled(a: jax.Array, b: jax.Array) -> jax.Array:
    """General (non-symmetric) solve a x = b by unrolled Gaussian
    elimination with implicit partial pivoting via `where` row-selects.

    a: [..., n, n]; b: [..., n, k].  Fully unrolled at trace time: every op
    is elementwise over the batch, with none of the
    sequential pivoted-LU machinery jnp.linalg.solve lowers to.
    """
    n = a.shape[-1]
    rows_a = [a[..., i, :] for i in range(n)]        # each [..., n]
    rows_b = [b[..., i, :] for i in range(n)]        # each [..., k]
    for j in range(n):
        # partial pivoting: pick the max-|a_ij| row among i >= j by a chain
        # of static compare-swaps (elementwise selects, no gathers)
        for i in range(j + 1, n):
            swap = (jnp.abs(rows_a[i][..., j])
                    > jnp.abs(rows_a[j][..., j]))[..., None]
            rows_a[j], rows_a[i] = (jnp.where(swap, rows_a[i], rows_a[j]),
                                    jnp.where(swap, rows_a[j], rows_a[i]))
            rows_b[j], rows_b[i] = (jnp.where(swap, rows_b[i], rows_b[j]),
                                    jnp.where(swap, rows_b[j], rows_b[i]))
        inv_p = 1.0 / rows_a[j][..., j]
        for i in range(j + 1, n):
            f = (rows_a[i][..., j] * inv_p)[..., None]
            rows_a[i] = rows_a[i] - f * rows_a[j]
            rows_b[i] = rows_b[i] - f * rows_b[j]
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        s = rows_b[i]
        for k2 in range(i + 1, n):
            s = s - rows_a[i][..., k2][..., None] * xs[k2]
        xs[i] = s / rows_a[i][..., i][..., None]
    return jnp.stack(xs, axis=-2)


def ge_solve(a: jax.Array, b: jax.Array) -> jax.Array:
    """Solve a x = b for general square a; b: [..., n] or [..., n, k].
    Unrolled for small n (elementwise over the batch), LAPACK-style
    fallback above."""
    vec = b.ndim == a.ndim - 1
    if vec:
        b = b[..., None]
    if a.shape[-1] <= _UNROLL_LIMIT:
        x = _ge_solve_unrolled(a, b)
    else:
        x = jnp.linalg.solve(a, b)
    return x[..., 0] if vec else x


def cho_inverse(l: jax.Array) -> jax.Array:
    """(L L^T)^{-1} via two triangular solves against identity."""
    n = l.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=l.dtype), l.shape)
    return cho_solve(l, eye)


def sym(a: jax.Array) -> jax.Array:
    """Symmetrize; the recursion only guarantees the lower triangle
    analytically (reference mirrors lower->upper, helpers.cpp:155-158)."""
    return 0.5 * (a + jnp.swapaxes(a, -1, -2))

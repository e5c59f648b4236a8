"""Flat-vector interop: the reference's flat primal/equality/inequality
layouts over the stagewise pytrees the solvers actually use.

The C++ reference hands the SIP core flat vectors and keeps offset tables
mapping (node/edge) -> position (reference: types.cpp:24-64,
populate_workspace_metadata):

  primal x = [x_0, u_0, x_1, u_1, ..., x_{E-1}, u_{E-1}, x_E, theta]
             (node i interleaved with edge i; types.cpp:33-41)
  equality y = [dyn_0, node_c_0, ..., dyn_E, node_c_E, edge_c_0, ...]
             (types.cpp:43-53; dyn_root is the root/initial-state row)
  inequality z = [node_g_0, ..., node_g_E, edge_g_0, ...]
             (types.cpp:55-63)

This framework never computes on these layouts (stagewise SoA arrays,
padded to max dims, are the compute format); this module exists for
(a) parity tests against dense oracles in the reference's coordinates,
(b) users migrating flat warm starts / bounds from the C++ stack.

All offsets are static Python ints derived from `Dimensions`; the flat <->
stagewise conversions are single gathers/scatters with trace-time-constant
index arrays, so they jit and vmap cleanly.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..types import Dimensions
from .kkt import KKTVector


@dataclasses.dataclass(frozen=True, eq=False)
class FlatLayout:
    """Offset tables + gather indices for one `Dimensions`.

    Offset semantics match the reference's workspace metadata
    (reference: types.cpp:33-63): `x_state_offsets[i]` is where node i's
    state starts in the flat primal, etc.  `*_gather` arrays index into the
    *flattened padded* stagewise storage (see `_concat_order` below).
    """

    dims: Dimensions
    x_state_offsets: np.ndarray    # [N]
    x_control_offsets: np.ndarray  # [E]
    theta_offset: int
    y_dyn_offsets: np.ndarray      # [N]
    y_node_c_offsets: np.ndarray   # [N]
    y_edge_c_offsets: np.ndarray   # [E]
    z_node_offsets: np.ndarray     # [N]
    z_edge_offsets: np.ndarray     # [E]
    # gather index arrays: flat position -> index into the concatenated
    # raveled padded arrays
    primal_gather: np.ndarray      # [x_dim]
    y_gather: np.ndarray           # [y_dim]
    z_gather: np.ndarray           # [z_dim]

    @property
    def x_dim(self) -> int:
        return self.dims.x_dim

    @property
    def y_dim(self) -> int:
        return self.dims.y_dim

    @property
    def z_dim(self) -> int:
        return self.dims.z_dim

    @property
    def kkt_dim(self) -> int:
        return self.dims.x_dim + self.dims.y_dim + self.dims.z_dim


def build_flat_layout(dims: Dimensions) -> FlatLayout:
    N, E = dims.num_nodes, dims.num_edges
    n = max(dims.max_state_dim, 1)
    m = max(dims.max_control_dim, 1)
    cn, ce = dims.max_node_c_dim, dims.max_edge_c_dim
    gn, ge = dims.max_node_g_dim, dims.max_edge_g_dim

    # --- primal offsets (reference: types.cpp:33-41) -----------------------
    x_state_offsets = np.zeros(N, dtype=np.int64)
    x_control_offsets = np.zeros(E, dtype=np.int64)
    off = 0
    for node in range(N):
        x_state_offsets[node] = off
        if node < E:
            off += dims.state_dims[node]
            x_control_offsets[node] = off
            off += dims.control_dims[node]
    theta_offset = dims.stagewise_x_dim

    # --- y offsets (reference: types.cpp:43-53) ----------------------------
    y_dyn_offsets = np.zeros(N, dtype=np.int64)
    y_node_c_offsets = np.zeros(N, dtype=np.int64)
    off = 0
    for node in range(N):
        y_dyn_offsets[node] = off
        off += dims.state_dims[node]
        y_node_c_offsets[node] = off
        off += dims.node_c_dims[node]
    y_edge_c_offsets = np.zeros(E, dtype=np.int64)
    for edge in range(E):
        y_edge_c_offsets[edge] = off
        off += dims.edge_c_dims[edge]

    # --- z offsets (reference: types.cpp:55-63) ----------------------------
    z_node_offsets = np.zeros(N, dtype=np.int64)
    off = 0
    for node in range(N):
        z_node_offsets[node] = off
        off += dims.node_g_dims[node]
    z_edge_offsets = np.zeros(E, dtype=np.int64)
    for edge in range(E):
        z_edge_offsets[edge] = off
        off += dims.edge_g_dims[edge]

    # --- gather maps into concatenated raveled padded storage --------------
    # primal concat order: [x (N*n) | u (E*m) | theta (p)]
    primal_gather = np.zeros(dims.x_dim, dtype=np.int64)
    for node in range(N):
        o = x_state_offsets[node]
        d = dims.state_dims[node]
        primal_gather[o:o + d] = node * n + np.arange(d)
    for edge in range(E):
        o = x_control_offsets[edge]
        d = dims.control_dims[edge]
        primal_gather[o:o + d] = N * n + edge * m + np.arange(d)
    primal_gather[theta_offset:] = N * n + E * m + np.arange(dims.theta_dim)

    # y concat order: [y_dyn (N*n) | y_nc (N*cn) | y_ec (E*ce)]
    y_gather = np.zeros(dims.y_dim, dtype=np.int64)
    for node in range(N):
        o = y_dyn_offsets[node]
        d = dims.state_dims[node]
        y_gather[o:o + d] = node * n + np.arange(d)
        o = y_node_c_offsets[node]
        d = dims.node_c_dims[node]
        y_gather[o:o + d] = N * n + node * cn + np.arange(d)
    for edge in range(E):
        o = y_edge_c_offsets[edge]
        d = dims.edge_c_dims[edge]
        y_gather[o:o + d] = N * n + N * cn + edge * ce + np.arange(d)

    # z concat order: [z_n (N*gn) | z_e (E*ge)]
    z_gather = np.zeros(dims.z_dim, dtype=np.int64)
    for node in range(N):
        o = z_node_offsets[node]
        d = dims.node_g_dims[node]
        z_gather[o:o + d] = node * gn + np.arange(d)
    for edge in range(E):
        o = z_edge_offsets[edge]
        d = dims.edge_g_dims[edge]
        z_gather[o:o + d] = N * gn + edge * ge + np.arange(d)

    return FlatLayout(
        dims=dims,
        x_state_offsets=x_state_offsets,
        x_control_offsets=x_control_offsets,
        theta_offset=theta_offset,
        y_dyn_offsets=y_dyn_offsets,
        y_node_c_offsets=y_node_c_offsets,
        y_edge_c_offsets=y_edge_c_offsets,
        z_node_offsets=z_node_offsets,
        z_edge_offsets=z_edge_offsets,
        primal_gather=primal_gather,
        y_gather=y_gather,
        z_gather=z_gather,
    )


# ---------------------------------------------------------------------------
# stagewise -> flat
# ---------------------------------------------------------------------------

def _primal_concat(x, u, theta):
    return jnp.concatenate(
        [x.reshape(x.shape[:-2] + (-1,)), u.reshape(u.shape[:-2] + (-1,)),
         theta], axis=-1)


def flatten_primal(layout: FlatLayout, x, u, theta) -> jax.Array:
    """(x [N,n], u [E,m], theta [p]) -> flat primal [x_dim]."""
    return jnp.take(_primal_concat(x, u, theta),
                    jnp.asarray(layout.primal_gather), axis=-1)


def flatten_y(layout: FlatLayout, y_dyn, y_nc, y_ec) -> jax.Array:
    cat = jnp.concatenate(
        [a.reshape(a.shape[:-2] + (-1,)) for a in (y_dyn, y_nc, y_ec)],
        axis=-1)
    return jnp.take(cat, jnp.asarray(layout.y_gather), axis=-1)


def flatten_z(layout: FlatLayout, z_n, z_e) -> jax.Array:
    cat = jnp.concatenate(
        [a.reshape(a.shape[:-2] + (-1,)) for a in (z_n, z_e)], axis=-1)
    return jnp.take(cat, jnp.asarray(layout.z_gather), axis=-1)


def flatten_kkt(layout: FlatLayout, v: KKTVector) -> jax.Array:
    """KKTVector -> flat [x_dim + y_dim + z_dim] in the reference ordering
    [x | y | z] (the ordering add_Kx_to_y is defined over,
    reference: helpers.cpp:953-977)."""
    return jnp.concatenate([
        flatten_primal(layout, v.x, v.u, v.theta),
        flatten_y(layout, v.y_dyn, v.y_nc, v.y_ec),
        flatten_z(layout, v.z_n, v.z_e)], axis=-1)


# ---------------------------------------------------------------------------
# flat -> stagewise (padded entries come back as zeros)
# ---------------------------------------------------------------------------

def unflatten_primal(layout: FlatLayout, flat) -> Tuple[jax.Array, jax.Array,
                                                        jax.Array]:
    dims = layout.dims
    N, E = dims.num_nodes, dims.num_edges
    n = max(dims.max_state_dim, 1)
    m = max(dims.max_control_dim, 1)
    total = N * n + E * m + dims.theta_dim
    cat = jnp.zeros(flat.shape[:-1] + (total,), flat.dtype)
    cat = cat.at[..., jnp.asarray(layout.primal_gather)].set(flat)
    x = cat[..., :N * n].reshape(flat.shape[:-1] + (N, n))
    u = cat[..., N * n:N * n + E * m].reshape(flat.shape[:-1] + (E, m))
    theta = cat[..., N * n + E * m:]
    return x, u, theta


def unflatten_y(layout: FlatLayout, flat):
    dims = layout.dims
    N, E = dims.num_nodes, dims.num_edges
    n = max(dims.max_state_dim, 1)
    cn, ce = dims.max_node_c_dim, dims.max_edge_c_dim
    total = N * n + N * cn + E * ce
    cat = jnp.zeros(flat.shape[:-1] + (total,), flat.dtype)
    cat = cat.at[..., jnp.asarray(layout.y_gather)].set(flat)
    y_dyn = cat[..., :N * n].reshape(flat.shape[:-1] + (N, n))
    y_nc = cat[..., N * n:N * n + N * cn].reshape(flat.shape[:-1] + (N, cn))
    y_ec = cat[..., N * n + N * cn:].reshape(flat.shape[:-1] + (E, ce))
    return y_dyn, y_nc, y_ec


def unflatten_z(layout: FlatLayout, flat):
    dims = layout.dims
    N, E = dims.num_nodes, dims.num_edges
    gn, ge = dims.max_node_g_dim, dims.max_edge_g_dim
    total = N * gn + E * ge
    cat = jnp.zeros(flat.shape[:-1] + (total,), flat.dtype)
    cat = cat.at[..., jnp.asarray(layout.z_gather)].set(flat)
    z_n = cat[..., :N * gn].reshape(flat.shape[:-1] + (N, gn))
    z_e = cat[..., N * gn:].reshape(flat.shape[:-1] + (E, ge))
    return z_n, z_e


def unflatten_kkt(layout: FlatLayout, flat) -> KKTVector:
    xd, yd = layout.x_dim, layout.y_dim
    x, u, theta = unflatten_primal(layout, flat[..., :xd])
    y_dyn, y_nc, y_ec = unflatten_y(layout, flat[..., xd:xd + yd])
    z_n, z_e = unflatten_z(layout, flat[..., xd + yd:])
    return KKTVector(x=x, u=u, theta=theta, y_dyn=y_dyn, y_nc=y_nc,
                     y_ec=y_ec, z_n=z_n, z_e=z_e)


# ---------------------------------------------------------------------------
# dense operators in flat coordinates (test/parity oracles)
# ---------------------------------------------------------------------------

def dense_kkt_matrix(layout: FlatLayout, model, regs, sched) -> jax.Array:
    """Materialize the full regularized Newton-KKT matrix in the reference's
    flat coordinates by applying the stagewise apply_K operator to basis
    vectors.  O(kkt_dim) operator applications — a test oracle, mirroring
    the dense cross-check pattern of the reference's tests
    (reference: tests/lqr_test.cpp:859-929)."""
    from .kkt import apply_K

    def column(e_flat):
        return flatten_kkt(layout,
                           apply_K(model, regs, unflatten_kkt(layout, e_flat),
                                   sched))

    eye = jnp.eye(layout.kkt_dim)
    return jax.jit(jax.vmap(column))(eye).T

"""Newton-KKT condensation, multiplier recovery, theta-Schur, and KKT
operators — the batched equivalent of the reference's CallbackProvider
(reference: sip_optimal_control/helpers.cpp).

The full regularized Newton-KKT operator over (x, y, z) with regularizations
(r1, r2, r3) and barrier weights w (reference: helpers.cpp:953-977):

    K = [[ H + diag(r1),  C^T,        G^T        ],
         [ C,            -diag(r2),   0          ],
         [ G,             0,         -diag(w+r3) ]]

where H is the Lagrangian Hessian (incl. theta blocks), C stacks
root/dynamics/node-equality/edge-equality rows and G stacks the inequality
rows.  ``factor`` eliminates the y_c and z rows into the stage Hessians
(condensation, reference: helpers.cpp:242-408):

    Q_mod = d2L/dx2 + diag(r1_x) + Jc^T diag(1/r2) Jc + Jg^T diag(1/(w+r3)) Jg
    R_mod, M_mod analogously; LQR delta = r2 of the dynamics rows,

leaving the tree-LQR system in (x, u, y_dyn), then (if theta_dim > 0)
Schur-eliminates theta against the stagewise KKT matrix
(reference: helpers.cpp:372-407).

Everything operates on *stagewise pytrees* of stacked SoA arrays — never on
the flat vectors the C++ uses; flat interop lives in `flatten.py`.  The
rank-k condensation accumulations are einsums; multiplier
recovery is a matmul epilogue (reference: helpers.cpp:828-893).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..types import Dimensions, FactorStatus, TopologySchedule
from .linalg import cholesky_with_ok, cho_solve
from .lqr import (LQRData, LQRFactorization, LQRSolution, lqr_factor,
                  lqr_solve, _merge_status)

_mv = lambda A, b: (A @ b[..., None])[..., 0]
_tmv = lambda A, b: (jnp.swapaxes(A, -1, -2) @ b[..., None])[..., 0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StageModelData:
    """Stacked model derivatives, the SoA equivalent of ModelCallbackOutput
    (reference: types.hpp:48-126).  Node-indexed arrays lead with [N],
    edge-indexed with [E]; constraint dims are padded to max and masked.

    Node terms depend only on the node state (+ theta); edge terms on the
    parent state, the control (+ theta).  The dynamics child-Jacobian is the
    fixed -I (reference: types.hpp:63-65).
    """

    # objective
    f_node: jax.Array          # [N]
    f_edge: jax.Array          # [E]
    df_dx_node: jax.Array      # [N, n]
    df_dx_edge: jax.Array      # [E, n]   (w.r.t. parent state)
    df_du: jax.Array           # [E, m]
    # dynamics residual and Jacobians
    dyn_res: jax.Array         # [E, n]   dyn(x_par, u) - x_child
    A: jax.Array               # [E, n, n] ddyn_dx (child x parent)
    B: jax.Array               # [E, n, m] ddyn_du
    # equality constraints
    c_node: jax.Array          # [N, cn]
    Jc_x_node: jax.Array       # [N, cn, n]
    c_edge: jax.Array          # [E, ce]
    Jc_x_edge: jax.Array       # [E, ce, n]
    Jc_u_edge: jax.Array       # [E, ce, m]
    # inequality constraints
    g_node: jax.Array          # [N, gn]
    Jg_x_node: jax.Array       # [N, gn, n]
    g_edge: jax.Array          # [E, ge]
    Jg_x_edge: jax.Array       # [E, ge, n]
    Jg_u_edge: jax.Array       # [E, ge, m]
    # Lagrangian Hessian blocks
    Hxx_node: jax.Array        # [N, n, n]
    Hxx_edge: jax.Array        # [E, n, n]
    Hxu_edge: jax.Array        # [E, n, m]
    Huu_edge: jax.Array        # [E, m, m]
    # theta blocks (shapes [..., p]; p may be 0)
    df_dtheta_node: jax.Array  # [N, p]
    df_dtheta_edge: jax.Array  # [E, p]
    ddyn_dtheta: jax.Array     # [E, n, p]
    Jc_th_node: jax.Array      # [N, cn, p]
    Jc_th_edge: jax.Array      # [E, ce, p]
    Jg_th_node: jax.Array      # [N, gn, p]
    Jg_th_edge: jax.Array      # [E, ge, p]
    Hxth_node: jax.Array       # [N, n, p]
    Hxth_edge: jax.Array       # [E, n, p]
    Huth_edge: jax.Array       # [E, m, p]
    Hthth_node: jax.Array      # [N, p, p]
    Hthth_edge: jax.Array      # [E, p, p]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class KKTVector:
    """A stagewise (x, y, z) KKT-space vector.

    Replaces the C++ flat vectors [x | theta | y | z] with a pytree; the
    flat ordering used by the reference lives in flatten.py for parity
    tests (reference layout: types.cpp:24-64)."""

    x: jax.Array        # [N, n]   states
    u: jax.Array        # [E, m]   controls
    theta: jax.Array    # [p]
    y_dyn: jax.Array    # [N, n]   dynamics multipliers (root row at root)
    y_nc: jax.Array     # [N, cn]  node equality multipliers
    y_ec: jax.Array     # [E, ce]  edge equality multipliers
    z_n: jax.Array      # [N, gn]  node inequality multipliers
    z_e: jax.Array      # [E, ge]  edge inequality multipliers

    def __add__(self, other):
        return jax.tree.map(jnp.add, self, other)

    def __sub__(self, other):
        return jax.tree.map(jnp.subtract, self, other)

    def scale(self, a):
        return jax.tree.map(lambda t: a * t, self)

    @property
    def primal_fields(self):
        return (self.x, self.u, self.theta)

    def dot(self, other) -> jax.Array:
        leaves = jax.tree.leaves(jax.tree.map(
            lambda a, b: jnp.sum(a * b), self, other))
        return sum(leaves)

    def norm(self) -> jax.Array:
        return jnp.sqrt(self.dot(self))


def zero_kkt_vector(dims: Dimensions, dtype=jnp.float64) -> KKTVector:
    N, E = dims.num_nodes, dims.num_edges
    n = max(dims.max_state_dim, 1)
    m = max(dims.max_control_dim, 1)
    return KKTVector(
        x=jnp.zeros((N, n), dtype), u=jnp.zeros((E, m), dtype),
        theta=jnp.zeros((dims.theta_dim,), dtype),
        y_dyn=jnp.zeros((N, n), dtype),
        y_nc=jnp.zeros((N, dims.max_node_c_dim), dtype),
        y_ec=jnp.zeros((E, dims.max_edge_c_dim), dtype),
        z_n=jnp.zeros((N, dims.max_node_g_dim), dtype),
        z_e=jnp.zeros((E, dims.max_edge_g_dim), dtype))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Regularizations:
    """The (w, r1, r2, r3) quadruple in stagewise layout
    (reference: factor() signature, helpers.hpp:11-12).

    w, r3 live on the z rows; r2 on the y rows (r2_dyn doubles as the LQR
    delta); r1 on the primal rows (incl. theta)."""

    w_n: jax.Array      # [N, gn]
    w_e: jax.Array      # [E, ge]
    r1_x: jax.Array     # [N, n]
    r1_u: jax.Array     # [E, m]
    r1_th: jax.Array    # [p]
    r2_dyn: jax.Array   # [N, n]
    r2_nc: jax.Array    # [N, cn]
    r2_ec: jax.Array    # [E, ce]
    r3_n: jax.Array     # [N, gn]
    r3_e: jax.Array     # [E, ge]


class KKTFactorization(NamedTuple):
    lqr_data: LQRData
    lqr_fact: LQRFactorization
    # cached weights
    nc_r2_inv: jax.Array       # [N, cn]
    ec_r2_inv: jax.Array       # [E, ce]
    n_w_inv: jax.Array         # [N, gn]
    e_w_inv: jax.Array         # [E, ge]
    # theta Schur path (empty arrays when p == 0)
    theta_solution: Optional[KKTVector]   # K^{-1} J_theta as p-stacked vectors
    theta_schur_chol: Optional[jax.Array]  # [p, p]
    status: jax.Array          # int32


@dataclasses.dataclass(frozen=True)
class ConstraintMasks:
    """Trace-time masks for padded constraint rows."""

    nc: np.ndarray   # [N, cn] bool
    ec: np.ndarray   # [E, ce]
    ng: np.ndarray   # [N, gn]
    eg: np.ndarray   # [E, ge]
    state: np.ndarray    # [N, n]
    control: np.ndarray  # [E, m]

    @staticmethod
    def build(dims: Dimensions) -> "ConstraintMasks":
        def mk(sizes, width):
            out = np.zeros((len(sizes), width), dtype=bool)
            for i, d in enumerate(sizes):
                out[i, :d] = True
            return out
        return ConstraintMasks(
            nc=mk(dims.node_c_dims, dims.max_node_c_dim),
            ec=mk(dims.edge_c_dims, dims.max_edge_c_dim),
            ng=mk(dims.node_g_dims, dims.max_node_g_dim),
            eg=mk(dims.edge_g_dims, dims.max_edge_g_dim),
            state=mk(dims.state_dims, max(dims.max_state_dim, 1)),
            control=mk(dims.control_dims, max(dims.max_control_dim, 1)))


def _safe_inv(v, mask):
    """1/v on live rows, 0 on padded rows; validity requires v > 0 on live
    rows (reference: helpers.cpp:251-295)."""
    live = jnp.asarray(mask)
    safe = jnp.where(live, v, 1.0)
    return jnp.where(live, 1.0 / safe, 0.0), jnp.all((v > 0) | ~live)


def kkt_factor(model: StageModelData, regs: Regularizations,
               masks: ConstraintMasks, sched: TopologySchedule,
               backend: str = "scan",
               axis_names: Tuple[str, ...] = ()) -> KKTFactorization:
    """Condense + LQR-factor (+ theta Schur).  Reference:
    CallbackProvider::factor (helpers.cpp:242-408).

    ``backend`` selects the chain Riccati implementation (see
    ops.lqr.lqr_factor).

    ``axis_names``: mapped axes (vmap and/or mesh) over which scenarios
    share ONE global theta (SURVEY 2.10(c)).  The theta Schur complement
    S_theta = sum_shards(sum d2L/dtheta2 - J_theta^T K^{-1} J_theta)
    + diag(r1_theta) is psum-reduced across them (the reference computes
    the same sum serially over all stages of one process,
    helpers.cpp:376-407); the stagewise factorization stays shard-local.
    Convention: per-lane theta quantities are CONTRIBUTIONS to the global
    sum — the caller masks lane-replicated terms (r1_th) to one lane."""
    parent = np.asarray(sched.topology.edge_parents)
    dtype = model.Hxx_node.dtype

    nc_r2_inv, ok1 = _safe_inv(regs.r2_nc, masks.nc)
    ec_r2_inv, ok2 = _safe_inv(regs.r2_ec, masks.ec)
    n_w_inv, ok3 = _safe_inv(regs.w_n + regs.r3_n, masks.ng)
    e_w_inv, ok4 = _safe_inv(regs.w_e + regs.r3_e, masks.eg)
    delta_ok = jnp.all((regs.r2_dyn > 0) | ~jnp.asarray(masks.state))
    weights_ok = ok1 & ok2 & ok3 & ok4 & delta_ok

    sm = jnp.asarray(masks.state, dtype)
    cm = jnp.asarray(masks.control, dtype)

    # --- node condensation (reference: helpers.cpp:297-316) ----------------
    def wjj(J, winv):
        # J^T diag(winv) J, batched over leading axis
        return jnp.einsum("...ki,...k,...kj->...ij", J, winv, J)

    Q_mod = (model.Hxx_node
             + _diag_embed(regs.r1_x * sm)
             + wjj(model.Jc_x_node, nc_r2_inv)
             + wjj(model.Jg_x_node, n_w_inv))

    # --- edge condensation (reference: helpers.cpp:318-354) ----------------
    Q_edge = (model.Hxx_edge
              + wjj(model.Jc_x_edge, ec_r2_inv)
              + wjj(model.Jg_x_edge, e_w_inv))
    Q_mod = Q_mod.at[parent].add(Q_edge)

    def wjj2(Jx, Ju, winv):
        return jnp.einsum("...ki,...k,...kj->...ij", Jx, winv, Ju)

    M_mod = (model.Hxu_edge
             + wjj2(model.Jc_x_edge, model.Jc_u_edge, ec_r2_inv)
             + wjj2(model.Jg_x_edge, model.Jg_u_edge, e_w_inv))
    R_mod = (model.Huu_edge
             + _diag_embed(regs.r1_u * cm)
             + wjj(model.Jc_u_edge, ec_r2_inv)
             + wjj(model.Jg_u_edge, e_w_inv))

    # pad plan: unit diagonal on dead state/control rows keeps Cholesky valid
    Q_mod = _mask_sym(Q_mod, sm)
    R_mod = _mask_sym(R_mod, cm)
    child_sm = sm[np.asarray(sched.topology.edge_children)]
    parent_sm = sm[parent]
    A = model.A * child_sm[:, :, None] * parent_sm[:, None, :]
    B = model.B * child_sm[:, :, None] * cm[:, None, :]
    M_mod = M_mod * parent_sm[:, :, None] * cm[:, None, :]
    delta = regs.r2_dyn * sm + (1.0 - sm)

    lqr_data = LQRData(
        Q=Q_mod, q=jnp.zeros_like(regs.r1_x), c=jnp.zeros_like(regs.r1_x),
        delta=delta, A=A, B=B, M=M_mod, R=R_mod,
        r=jnp.zeros_like(regs.r1_u))
    lqr_fact = lqr_factor(lqr_data, sched, backend)
    status = jnp.where(weights_ok, lqr_fact.status,
                       jnp.int32(FactorStatus.INVALID_DELTA))

    fact = KKTFactorization(
        lqr_data=lqr_data, lqr_fact=lqr_fact,
        nc_r2_inv=nc_r2_inv, ec_r2_inv=ec_r2_inv,
        n_w_inv=n_w_inv, e_w_inv=e_w_inv,
        theta_solution=None, theta_schur_chol=None, status=status)

    p = model.Hthth_node.shape[-1]
    if p == 0:
        return fact

    # --- theta Schur path (reference: helpers.cpp:372-407) -----------------
    j_theta = _theta_jacobian_columns(model, sched)      # KKTVector w/ [p,...]
    k_inv_j = jax.vmap(
        lambda b: _solve_stagewise(fact, model, b, sched,
                                   backend))(j_theta)
    s_theta = (jnp.sum(model.Hthth_node, axis=0)
               + jnp.sum(model.Hthth_edge, axis=0)
               + jnp.diag(regs.r1_th)
               - _theta_dot(j_theta, k_inv_j))
    if axis_names:
        # shared-theta mode: sum local Schur contributions across all
        # scenario lanes/shards; every lane then factors the identical
        # global p x p system
        s_theta = jax.lax.psum(s_theta, axis_names)
    s_chol, s_ok = cholesky_with_ok(s_theta)
    status = _merge_status(status, jnp.where(
        s_ok, FactorStatus.SUCCESS,
        FactorStatus.G_FACTORIZATION_FAILURE).astype(jnp.int32))
    return fact._replace(theta_solution=k_inv_j, theta_schur_chol=s_chol,
                         status=status)


def _diag_embed(v):
    return jnp.zeros(v.shape + (v.shape[-1],), v.dtype) \
        .at[..., jnp.arange(v.shape[-1]), jnp.arange(v.shape[-1])].set(v)


def _mask_sym(Qm, mask):
    dead = 1.0 - mask
    return (Qm * mask[..., :, None] * mask[..., None, :]
            + _diag_embed(dead))


def _theta_jacobian_columns(model: StageModelData,
                            sched: TopologySchedule) -> KKTVector:
    """The theta coupling Jacobian J_theta as p stacked stagewise KKT
    vectors (reference: form_theta_jacobian, helpers.cpp:190-240).
    Each returned leaf has a leading axis p."""
    parent = np.asarray(sched.topology.edge_parents)
    p = model.Hthth_node.shape[-1]

    def cols(a):  # [..., p] -> [p, ...]
        return jnp.moveaxis(a, -1, 0)

    x = cols(model.Hxth_node)                        # [p, N, n]
    x = x.at[:, parent].add(cols(model.Hxth_edge))
    return KKTVector(
        x=x,
        u=cols(model.Huth_edge),
        theta=jnp.zeros((p, p), model.Hthth_node.dtype),
        y_dyn=jnp.zeros((p,) + model.df_dx_node.shape,
                        model.Hthth_node.dtype).at[:, np.asarray(
                            sched.topology.edge_children)].set(
                                cols(model.ddyn_dtheta)),
        y_nc=cols(model.Jc_th_node),
        y_ec=cols(model.Jc_th_edge),
        z_n=cols(model.Jg_th_node),
        z_e=cols(model.Jg_th_edge))


def _theta_dot(a: KKTVector, b: KKTVector) -> jax.Array:
    """J^T K^{-1} J over the stagewise components: [p, ...] x [p, ...] ->
    [p, p] (theta components excluded — they are zero in J_theta's stagewise
    part)."""
    total = 0.0
    for name in ("x", "u", "y_dyn", "y_nc", "y_ec", "z_n", "z_e"):
        fa = getattr(a, name).reshape(a.x.shape[0], -1)
        fb = getattr(b, name).reshape(b.x.shape[0], -1)
        total = total + fa @ fb.T
    return total


def _solve_stagewise(fact: KKTFactorization, model: StageModelData,
                     b: KKTVector, sched: TopologySchedule,
                     backend: str = "scan") -> KKTVector:
    """Solve the stagewise (theta-free) KKT system for one RHS.

    Reference: solve_stagewise_kkt_matrix (helpers.cpp:414-894): condense the
    RHS into (q_mod, r_mod, c_mod), run the LQR solve, then recover the
    eliminated multipliers y_c = (J_c x_sol - b_yc)/r2 and
    z = (J_g x_sol - b_z)/(w+r3)."""
    parent = np.asarray(sched.topology.edge_parents)
    child = np.asarray(sched.topology.edge_children)

    # RHS condensation (reference: helpers.cpp:752-812)
    wc_n = fact.nc_r2_inv * b.y_nc
    wg_n = fact.n_w_inv * b.z_n
    q_mod = -b.x - _tmv(model.Jc_x_node, wc_n) - _tmv(model.Jg_x_node, wg_n)
    wc_e = fact.ec_r2_inv * b.y_ec
    wg_e = fact.e_w_inv * b.z_e
    q_mod = q_mod.at[parent].add(
        -_tmv(model.Jc_x_edge, wc_e) - _tmv(model.Jg_x_edge, wg_e))
    r_mod = -b.u - _tmv(model.Jc_u_edge, wc_e) - _tmv(model.Jg_u_edge, wg_e)
    c_mod = -b.y_dyn

    data = dataclasses.replace(fact.lqr_data, q=q_mod, r=r_mod, c=c_mod)
    sol = lqr_solve(data, fact.lqr_fact, sched, backend)

    # multiplier recovery (reference: helpers.cpp:828-893)
    y_nc = fact.nc_r2_inv * (_mv(model.Jc_x_node, sol.x) - b.y_nc)
    z_n = fact.n_w_inv * (_mv(model.Jg_x_node, sol.x) - b.z_n)
    x_par = sol.x[parent]
    y_ec = fact.ec_r2_inv * (_mv(model.Jc_x_edge, x_par)
                             + _mv(model.Jc_u_edge, sol.u) - b.y_ec)
    z_e = fact.e_w_inv * (_mv(model.Jg_x_edge, x_par)
                          + _mv(model.Jg_u_edge, sol.u) - b.z_e)

    return KKTVector(x=sol.x, u=sol.u,
                     theta=jnp.zeros_like(b.theta),
                     y_dyn=sol.y, y_nc=y_nc, y_ec=y_ec, z_n=z_n, z_e=z_e)


def kkt_solve(fact: KKTFactorization, model: StageModelData, b: KKTVector,
              sched: TopologySchedule,
              backend: str = "scan",
              axis_names: Tuple[str, ...] = ()) -> KKTVector:
    """Full KKT solve incl. theta back-substitution.

    Reference: CallbackProvider::solve (helpers.cpp:896-951).

    With ``axis_names`` (shared global theta across scenario lanes/shards,
    SURVEY 2.10(c)): b.theta carries the LANE-LOCAL contribution to the
    global theta RHS; the reduced RHS is psum-ed, each lane solves the
    identical Schur system, and the (replicated) dtheta is back-substituted
    into the lane-local stagewise solution."""
    sol = _solve_stagewise(fact, model, b, sched, backend)
    p = b.theta.shape[-1]
    if p == 0:
        return sol

    j_theta = _theta_jacobian_columns(model, sched)
    theta_rhs = b.theta - _theta_vec_dot(j_theta, sol)
    if axis_names:
        theta_rhs = jax.lax.psum(theta_rhs, axis_names)
    dtheta = cho_solve(fact.theta_schur_chol, theta_rhs)
    correction = jax.tree.map(
        lambda cols: jnp.tensordot(dtheta, cols, axes=(0, 0)),
        fact.theta_solution)
    sol = sol - correction
    return dataclasses.replace(sol, theta=dtheta)


def _theta_vec_dot(cols: KKTVector, v: KKTVector) -> jax.Array:
    """J_theta^T v for stagewise v -> [p]."""
    total = 0.0
    for name in ("x", "u", "y_dyn", "y_nc", "y_ec", "z_n", "z_e"):
        fc = getattr(cols, name).reshape(cols.x.shape[0], -1)
        fv = getattr(v, name).reshape(-1)
        total = total + fc @ fv
    return total


# ---------------------------------------------------------------------------
# KKT matvec oracles (reference: helpers.cpp:953-1368) — used for residual
# checks, iterative refinement, and the round-trip test oracle.
# ---------------------------------------------------------------------------

def apply_H(model: StageModelData, v: KKTVector,
            sched: TopologySchedule) -> KKTVector:
    """y += H x on primal components (reference: add_Hx_to_y,
    helpers.cpp:979-1068)."""
    parent = np.asarray(sched.topology.edge_parents)
    x_par = v.x[parent]
    out_x = _mv(model.Hxx_node, v.x)
    out_x = out_x.at[parent].add(_mv(model.Hxx_edge, x_par)
                                 + _mv(model.Hxu_edge, v.u))
    out_u = _tmv(model.Hxu_edge, x_par) + _mv(model.Huu_edge, v.u)
    p = v.theta.shape[-1]
    out_th = jnp.zeros_like(v.theta)
    if p > 0:
        out_x = out_x + _mv(model.Hxth_node, jnp.broadcast_to(
            v.theta, model.Hxth_node.shape[:-2] + (p,)))
        out_x = out_x.at[parent].add(_mv(model.Hxth_edge, jnp.broadcast_to(
            v.theta, model.Hxth_edge.shape[:-2] + (p,))))
        out_u = out_u + _mv(model.Huth_edge, jnp.broadcast_to(
            v.theta, model.Huth_edge.shape[:-2] + (p,)))
        out_th = (jnp.einsum("Nnp,Nn->p", model.Hxth_node, v.x)
                  + jnp.einsum("Enp,En->p", model.Hxth_edge, x_par)
                  + jnp.einsum("Emp,Em->p", model.Huth_edge, v.u)
                  + (jnp.sum(model.Hthth_node, axis=0)
                     + jnp.sum(model.Hthth_edge, axis=0)) @ v.theta)
    return dataclasses.replace(
        zero_like(v), x=out_x, u=out_u, theta=out_th)


def apply_C(model: StageModelData, v: KKTVector,
            sched: TopologySchedule) -> KKTVector:
    """Equality-Jacobian product: rows (root, dynamics, node c, edge c)
    (reference: add_Cx_to_y, helpers.cpp:1070-1159)."""
    parent = np.asarray(sched.topology.edge_parents)
    child = np.asarray(sched.topology.edge_children)
    root = sched.topology.root
    x_par = v.x[parent]

    y_dyn = jnp.zeros_like(v.y_dyn)
    y_dyn = y_dyn.at[root].add(-v.x[root])
    y_dyn = y_dyn.at[child].add(_mv(model.A, x_par) + _mv(model.B, v.u)
                                - v.x[child])
    y_nc = _mv(model.Jc_x_node, v.x)
    y_ec = _mv(model.Jc_x_edge, x_par) + _mv(model.Jc_u_edge, v.u)
    p = v.theta.shape[-1]
    if p > 0:
        y_dyn = y_dyn.at[child].add(_mv(model.ddyn_dtheta, jnp.broadcast_to(
            v.theta, model.ddyn_dtheta.shape[:-2] + (p,))))
        y_nc = y_nc + _mv(model.Jc_th_node, jnp.broadcast_to(
            v.theta, model.Jc_th_node.shape[:-2] + (p,)))
        y_ec = y_ec + _mv(model.Jc_th_edge, jnp.broadcast_to(
            v.theta, model.Jc_th_edge.shape[:-2] + (p,)))
    return dataclasses.replace(zero_like(v), y_dyn=y_dyn, y_nc=y_nc,
                               y_ec=y_ec)


def apply_CT(model: StageModelData, v: KKTVector,
             sched: TopologySchedule) -> KKTVector:
    """Transpose equality product (reference: add_CTx_to_y,
    helpers.cpp:1161-1250)."""
    parent = np.asarray(sched.topology.edge_parents)
    child = np.asarray(sched.topology.edge_children)
    root = sched.topology.root
    dyn_child = v.y_dyn[child]

    out_x = _tmv(model.Jc_x_node, v.y_nc)
    out_x = out_x.at[root].add(-v.y_dyn[root])
    out_x = out_x.at[parent].add(_tmv(model.A, dyn_child)
                                 + _tmv(model.Jc_x_edge, v.y_ec))
    out_x = out_x.at[child].add(-dyn_child)
    out_u = _tmv(model.B, dyn_child) + _tmv(model.Jc_u_edge, v.y_ec)
    p = v.theta.shape[-1]
    out_th = jnp.zeros_like(v.theta)
    if p > 0:
        out_th = (jnp.einsum("Ncp,Nc->p", model.Jc_th_node, v.y_nc)
                  + jnp.einsum("Enp,En->p", model.ddyn_dtheta, dyn_child)
                  + jnp.einsum("Ecp,Ec->p", model.Jc_th_edge, v.y_ec))
    return dataclasses.replace(zero_like(v), x=out_x, u=out_u, theta=out_th)


def apply_G(model: StageModelData, v: KKTVector,
            sched: TopologySchedule) -> KKTVector:
    """Inequality-Jacobian product (reference: add_Gx_to_y,
    helpers.cpp:1252-1309)."""
    parent = np.asarray(sched.topology.edge_parents)
    x_par = v.x[parent]
    z_n = _mv(model.Jg_x_node, v.x)
    z_e = _mv(model.Jg_x_edge, x_par) + _mv(model.Jg_u_edge, v.u)
    p = v.theta.shape[-1]
    if p > 0:
        z_n = z_n + _mv(model.Jg_th_node, jnp.broadcast_to(
            v.theta, model.Jg_th_node.shape[:-2] + (p,)))
        z_e = z_e + _mv(model.Jg_th_edge, jnp.broadcast_to(
            v.theta, model.Jg_th_edge.shape[:-2] + (p,)))
    return dataclasses.replace(zero_like(v), z_n=z_n, z_e=z_e)


def apply_GT(model: StageModelData, v: KKTVector,
             sched: TopologySchedule) -> KKTVector:
    """Transpose inequality product (reference: add_GTx_to_y,
    helpers.cpp:1311-1368)."""
    parent = np.asarray(sched.topology.edge_parents)
    out_x = _tmv(model.Jg_x_node, v.z_n)
    out_x = out_x.at[parent].add(_tmv(model.Jg_x_edge, v.z_e))
    out_u = _tmv(model.Jg_u_edge, v.z_e)
    p = v.theta.shape[-1]
    out_th = jnp.zeros_like(v.theta)
    if p > 0:
        out_th = (jnp.einsum("Ngp,Ng->p", model.Jg_th_node, v.z_n)
                  + jnp.einsum("Egp,Eg->p", model.Jg_th_edge, v.z_e))
    return dataclasses.replace(zero_like(v), x=out_x, u=out_u, theta=out_th)


def apply_K(model: StageModelData, regs: Regularizations, v: KKTVector,
            sched: TopologySchedule) -> KKTVector:
    """The full regularized KKT operator (reference: add_Kx_to_y,
    helpers.cpp:953-977).  Defines the exact system kkt_solve solves."""
    h = apply_H(model, v, sched)
    c = apply_C(model, v, sched)
    ct = apply_CT(model, v, sched)
    g = apply_G(model, v, sched)
    gt = apply_GT(model, v, sched)
    return KKTVector(
        x=h.x + ct.x + gt.x + regs.r1_x * v.x,
        u=h.u + ct.u + gt.u + regs.r1_u * v.u,
        theta=h.theta + ct.theta + gt.theta + regs.r1_th * v.theta,
        y_dyn=c.y_dyn - regs.r2_dyn * v.y_dyn,
        y_nc=c.y_nc - regs.r2_nc * v.y_nc,
        y_ec=c.y_ec - regs.r2_ec * v.y_ec,
        z_n=g.z_n - (regs.w_n + regs.r3_n) * v.z_n,
        z_e=g.z_e - (regs.w_e + regs.r3_e) * v.z_e)


def zero_like(v: KKTVector) -> KKTVector:
    return jax.tree.map(jnp.zeros_like, v)

"""Autodiff model front door.

Replaces the reference's hand-filled derivative callback structs
(reference: types.hpp:48-126 — NodeModelCallbackOutput /
EdgeModelCallbackOutput with 20+ manually provided Jacobian/Hessian blocks)
with pure JAX stage functions differentiated automatically: the user
supplies costs, dynamics and constraints; `build_problem` produces the
stacked StageModelData arrays via vmapped jacfwd/hessian over the stage
axis, evaluated lazily inside the solver's jitted loop.

Semantics match the reference exactly (reference: types.hpp:46-65):
node terms depend only on the node state (+ theta); edge terms on the parent
state, the control (+ theta); the dynamics child-Jacobian is the fixed -I;
the dynamics residual is dyn(x_parent, u, theta) - x_child and the root row
residual is initial_state - x_root
(reference: sip_optimal_control.cpp:90-112).

An escape hatch remains: the solver consumes any OCProblem whose
`eval_model` returns StageModelData, so hand-derived (or Gauss-Newton)
models plug in without this module.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .types import Dimensions, Topology, TopologySchedule, compile_topology
from .ops.kkt import ConstraintMasks, StageModelData
from .solver.sip import ModelEval, OCProblem, Primal, YVec, ZVec


def _zero_fn(out_dim):
    def fn(*args):
        return jnp.zeros((out_dim,))
    return fn


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """User-facing problem description as pure stage functions.

    Signatures (all optional except dynamics; i is the node/edge index so
    time-varying terms can index closed-over arrays):
      node_cost(x, theta, i)        -> scalar
      edge_cost(x_parent, u, theta, i) -> scalar
      dynamics(x_parent, u, theta, i)  -> x_child prediction [n]
      node_eq(x, theta, i)          -> [node_c_dim]   (== 0)
      node_ineq(x, theta, i)        -> [node_g_dim]   (<= 0)
      edge_eq(x_parent, u, theta, i)   -> [edge_c_dim]
      edge_ineq(x_parent, u, theta, i) -> [edge_g_dim]
    """

    dynamics: Callable
    node_cost: Optional[Callable] = None
    edge_cost: Optional[Callable] = None
    node_eq: Optional[Callable] = None
    node_ineq: Optional[Callable] = None
    edge_eq: Optional[Callable] = None
    edge_ineq: Optional[Callable] = None


def box_bounds(dims: Dimensions, x_lower=None, x_upper=None, u_lower=None,
               u_upper=None, theta_lower=None, theta_upper=None,
               dtype=None):
    """Build Primal bound pytrees; None means unbounded.  Scalars or
    broadcastable arrays accepted.  Padded (dead) entries are forced
    unbounded (reference keeps bounds in the flat primal layout,
    types.hpp:141-144)."""
    dtype = dtype or jnp.result_type(float)
    masks = ConstraintMasks.build(dims)
    N, E = dims.num_nodes, dims.num_edges
    n = max(dims.max_state_dim, 1)
    m = max(dims.max_control_dim, 1)

    def expand(val, shape, default, mask=None):
        arr = jnp.broadcast_to(
            jnp.asarray(default if val is None else val, dtype), shape)
        if mask is not None:
            arr = jnp.where(jnp.asarray(mask), arr, default)
        return arr

    lower = Primal(x=expand(x_lower, (N, n), -jnp.inf, masks.state),
                   u=expand(u_lower, (E, m), -jnp.inf, masks.control),
                   theta=expand(theta_lower, (dims.theta_dim,), -jnp.inf))
    upper = Primal(x=expand(x_upper, (N, n), jnp.inf, masks.state),
                   u=expand(u_upper, (E, m), jnp.inf, masks.control),
                   theta=expand(theta_upper, (dims.theta_dim,), jnp.inf))
    return lower, upper


def build_problem(spec: ModelSpec, dims: Dimensions, topology: Topology,
                  initial_state, lower: Optional[Primal] = None,
                  upper: Optional[Primal] = None,
                  scale_dual=1.0, scale_equality=1.0, scale_bound=1.0,
                  init_mode: str = "constant",
                  hessian_mode: str = "exact") -> OCProblem:
    """Assemble an OCProblem with autodiff derivative evaluation.

    Variable stage dimensions (BASELINE config 2; reference:
    tests/variable_dimensions_test.cpp) are handled by padding: the user's
    stage functions are written on max-dim padded arrays (dead input
    entries arrive as zeros; dead output rows are ignored), and every
    residual/Jacobian/Hessian row and column beyond a stage's declared
    dimension is masked out here before the solver sees it.

    ``scale_dual`` / ``scale_equality`` / ``scale_bound`` are the
    convergence-test residual scalings: scalars, or per-element pytrees
    (Primal-shaped for dual/bound, YVec-shaped for equality) mirroring the
    reference's ResidualScaling double arrays (reference: types.hpp:144-148,
    wired at tests/variable_dimensions_test.cpp:421-427).

    ``hessian_mode``: "exact" differentiates the full stage Lagrangian
    (the reference's callback contract, types.hpp:48-126 — constraint and
    dynamics curvature included); "gauss_newton" keeps only the objective's
    Hessian blocks — exact for quadratic costs, cheaper to evaluate (no
    second-order autodiff through dynamics/constraints), and often more
    robust far from the solution (the classic real-time-MPC choice)."""
    sched = compile_topology(topology)
    masks = ConstraintMasks.build(dims)
    N, E = dims.num_nodes, dims.num_edges
    n = max(dims.max_state_dim, 1)
    m = max(dims.max_control_dim, 1)
    p = dims.theta_dim
    cn, ce = dims.max_node_c_dim, dims.max_edge_c_dim
    gn, ge = dims.max_node_g_dim, dims.max_edge_g_dim
    parent = np.asarray(topology.edge_parents)
    child = np.asarray(topology.edge_children)
    root = topology.root
    node_ids = jnp.arange(N)
    edge_ids = jnp.arange(E)
    initial_state = jnp.asarray(initial_state)
    if initial_state.shape[-1] < n:        # pad to max state dim
        initial_state = jnp.concatenate(
            [initial_state,
             jnp.zeros(initial_state.shape[:-1]
                       + (n - initial_state.shape[-1],),
                       initial_state.dtype)], axis=-1)

    # trace-time masks for variable dims (all-ones when uniform)
    uniform = dims.is_uniform
    ftype = jnp.result_type(float)
    sm = jnp.asarray(masks.state, ftype)           # [N, n]
    cm = jnp.asarray(masks.control, ftype)         # [E, m]
    sm_child = sm[child]
    sm_par = sm[parent]
    ncm = jnp.asarray(masks.nc, ftype)
    ecm = jnp.asarray(masks.ec, ftype)
    ngm = jnp.asarray(masks.ng, ftype)
    egm = jnp.asarray(masks.eg, ftype)

    def mrow(a, rmask):
        """Mask leading output rows: a [S, r, ...] * rmask [S, r]."""
        return a * rmask.reshape(rmask.shape + (1,) * (a.ndim - rmask.ndim))

    node_cost = spec.node_cost or (lambda x, th, i: jnp.asarray(0.0))
    edge_cost = spec.edge_cost or (lambda x, u, th, i: jnp.asarray(0.0))
    node_eq = spec.node_eq or _zero_fn(cn)
    node_ineq = spec.node_ineq or _zero_fn(gn)
    edge_eq = spec.edge_eq or _zero_fn(ce)
    edge_ineq = spec.edge_ineq or _zero_fn(ge)

    if lower is None or upper is None:
        default_lower, default_upper = box_bounds(dims)
        lower = lower or default_lower
        upper = upper or default_upper

    # ----- residual-only evaluation (line-search probes; the reference's
    # new_x=false path, sip_optimal_control.cpp:47-53) --------------------
    def eval_fcg(vars: Primal):
        th = vars.theta
        x_par = vars.x[parent]
        f = (jnp.sum(jax.vmap(node_cost, (0, None, 0))(vars.x, th, node_ids))
             + jnp.sum(jax.vmap(edge_cost, (0, 0, None, 0))(
                 x_par, vars.u, th, edge_ids)))
        dyn_pred = jax.vmap(spec.dynamics, (0, 0, None, 0))(
            x_par, vars.u, th, edge_ids)
        dyn_res = dyn_pred - vars.x[child]
        nc = jax.vmap(node_eq, (0, None, 0))(vars.x, th, node_ids)
        ec = jax.vmap(edge_eq, (0, 0, None, 0))(x_par, vars.u, th, edge_ids)
        gn = jax.vmap(node_ineq, (0, None, 0))(vars.x, th, node_ids)
        ge = jax.vmap(edge_ineq, (0, 0, None, 0))(x_par, vars.u, th,
                                                  edge_ids)
        root_res = initial_state - vars.x[root]
        if not uniform:
            dyn_res = dyn_res * sm_child
            root_res = root_res * sm[root]
            nc, ec, gn, ge = nc * ncm, ec * ecm, gn * ngm, ge * egm
        c_dyn = jnp.zeros_like(vars.x)
        c_dyn = c_dyn.at[root].set(root_res)
        c_dyn = c_dyn.at[child].set(dyn_res)
        return f, YVec(dyn=c_dyn, nc=nc, ec=ec), ZVec(n=gn, e=ge)

    # ----- stage Lagrangians (for Hessian blocks) -------------------------
    def node_lagrangian(x, th, i, y_nc, z_n):
        return (node_cost(x, th, i) + jnp.dot(y_nc, node_eq(x, th, i))
                + jnp.dot(z_n, node_ineq(x, th, i)))

    def edge_lagrangian(xp, u, th, i, y_dyn_child, y_ec, z_e):
        return (edge_cost(xp, u, th, i)
                + jnp.dot(y_dyn_child, spec.dynamics(xp, u, th, i))
                + jnp.dot(y_ec, edge_eq(xp, u, th, i))
                + jnp.dot(z_e, edge_ineq(xp, u, th, i)))

    if hessian_mode == "gauss_newton":
        node_hess = jax.hessian(
            lambda x, th, i, y_nc, z_n: node_cost(x, th, i),
            argnums=(0, 1))
        edge_hess = jax.hessian(
            lambda xp, u, th, i, y_dyn, y_ec, z_e: edge_cost(xp, u, th, i),
            argnums=(0, 1, 2))
    elif hessian_mode == "exact":
        node_hess = jax.hessian(node_lagrangian, argnums=(0, 1))
        edge_hess = jax.hessian(edge_lagrangian, argnums=(0, 1, 2))
    else:
        raise ValueError(f"unknown hessian_mode {hessian_mode!r}")

    def eval_model(vars: Primal, y: YVec, z: ZVec) -> ModelEval:
        th = vars.theta
        x_par = vars.x[parent]
        y_dyn_child = y.dyn[child]

        f, c, g = eval_fcg(vars)

        # first derivatives of the objective
        dnc = jax.vmap(jax.grad(node_cost, argnums=(0, 1)), (0, None, 0))(
            vars.x, th, node_ids)
        dec = jax.vmap(jax.grad(edge_cost, argnums=(0, 1, 2)),
                       (0, 0, None, 0))(x_par, vars.u, th, edge_ids)
        grad_x = dnc[0]
        grad_x = grad_x.at[parent].add(dec[0])
        grad_u = dec[1]
        grad_th = jnp.sum(dnc[1], axis=0) + jnp.sum(dec[2], axis=0)
        if not uniform:
            grad_x, grad_u = grad_x * sm, grad_u * cm
        grad = Primal(x=grad_x, u=grad_u, theta=grad_th)

        # constraint Jacobians
        A, B, dA_th = jax.vmap(
            jax.jacfwd(spec.dynamics, argnums=(0, 1, 2)), (0, 0, None, 0))(
                x_par, vars.u, th, edge_ids)
        Jc_n = jax.vmap(jax.jacfwd(node_eq, argnums=(0, 1)), (0, None, 0))(
            vars.x, th, node_ids)
        Jg_n = jax.vmap(jax.jacfwd(node_ineq, argnums=(0, 1)), (0, None, 0))(
            vars.x, th, node_ids)
        Jc_e = jax.vmap(jax.jacfwd(edge_eq, argnums=(0, 1, 2)),
                        (0, 0, None, 0))(x_par, vars.u, th, edge_ids)
        Jg_e = jax.vmap(jax.jacfwd(edge_ineq, argnums=(0, 1, 2)),
                        (0, 0, None, 0))(x_par, vars.u, th, edge_ids)

        # Lagrangian Hessian blocks
        Hn = jax.vmap(node_hess, (0, None, 0, 0, 0))(
            vars.x, th, node_ids, y.nc, z.n)
        He = jax.vmap(edge_hess, (0, 0, None, 0, 0, 0, 0))(
            x_par, vars.u, th, edge_ids, y_dyn_child, y.ec, z.e)

        stage = StageModelData(
            f_node=jnp.zeros((N,)), f_edge=jnp.zeros((E,)),
            df_dx_node=dnc[0], df_dx_edge=dec[0], df_du=dec[1],
            dyn_res=c.dyn[child],
            A=A, B=B,
            c_node=c.nc, Jc_x_node=Jc_n[0],
            c_edge=c.ec, Jc_x_edge=Jc_e[0], Jc_u_edge=Jc_e[1],
            g_node=g.n, Jg_x_node=Jg_n[0],
            g_edge=g.e, Jg_x_edge=Jg_e[0], Jg_u_edge=Jg_e[1],
            Hxx_node=Hn[0][0], Hxx_edge=He[0][0], Hxu_edge=He[0][1],
            Huu_edge=He[1][1],
            df_dtheta_node=dnc[1], df_dtheta_edge=dec[2],
            ddyn_dtheta=dA_th,
            Jc_th_node=Jc_n[1], Jc_th_edge=Jc_e[2],
            Jg_th_node=Jg_n[1], Jg_th_edge=Jg_e[2],
            Hxth_node=Hn[0][1], Hxth_edge=He[0][2], Huth_edge=He[1][2],
            Hthth_node=Hn[1][1], Hthth_edge=He[2][2])

        if not uniform:
            # zero every derivative row/column beyond the stage's declared
            # dims, so the KKT operators and condensation see exactly the
            # reference's per-stage blocks (types.cpp uses exact sizes;
            # here dead entries are identically zero instead)
            def m2(a, r, c_):
                return a * r[..., :, None] * c_[..., None, :]
            stage = dataclasses.replace(
                stage,
                df_dx_node=stage.df_dx_node * sm,
                df_dx_edge=stage.df_dx_edge * sm_par,
                df_du=stage.df_du * cm,
                A=m2(stage.A, sm_child, sm_par),
                B=m2(stage.B, sm_child, cm),
                Jc_x_node=m2(stage.Jc_x_node, ncm, sm),
                Jc_x_edge=m2(stage.Jc_x_edge, ecm, sm_par),
                Jc_u_edge=m2(stage.Jc_u_edge, ecm, cm),
                Jg_x_node=m2(stage.Jg_x_node, ngm, sm),
                Jg_x_edge=m2(stage.Jg_x_edge, egm, sm_par),
                Jg_u_edge=m2(stage.Jg_u_edge, egm, cm),
                Hxx_node=m2(stage.Hxx_node, sm, sm),
                Hxx_edge=m2(stage.Hxx_edge, sm_par, sm_par),
                Hxu_edge=m2(stage.Hxu_edge, sm_par, cm),
                Huu_edge=m2(stage.Huu_edge, cm, cm),
                ddyn_dtheta=mrow(stage.ddyn_dtheta, sm_child),
                Jc_th_node=mrow(stage.Jc_th_node, ncm),
                Jc_th_edge=mrow(stage.Jc_th_edge, ecm),
                Jg_th_node=mrow(stage.Jg_th_node, ngm),
                Jg_th_edge=mrow(stage.Jg_th_edge, egm),
                Hxth_node=mrow(stage.Hxth_node, sm),
                Hxth_edge=mrow(stage.Hxth_edge, sm_par),
                Huth_edge=mrow(stage.Huth_edge, cm))

        return ModelEval(f=f, grad=grad, c=c, g=g, stage=stage)

    # default primal init: constant trajectory at the initial state (cheap,
    # root-feasible) or an open-loop zero-control rollout
    if init_mode == "rollout":
        def roll(x_prev, e):
            nxt = spec.dynamics(x_prev, jnp.zeros((m,)), jnp.zeros((p,)), e)
            return nxt, nxt
        _, xs = jax.lax.scan(roll, initial_state, edge_ids)
        x_init = jnp.concatenate([initial_state[None], xs], axis=0)
        if not topology.is_chain:
            x_init = jnp.tile(initial_state[None], (N, 1))
    else:
        x_init = jnp.tile(initial_state[None], (N, 1))
    default_init = Primal(x=x_init, u=jnp.zeros((E, m)),
                          theta=jnp.zeros((p,)))

    return OCProblem(dims=dims, sched=sched, masks=masks,
                     eval_model=eval_model, eval_fcg=eval_fcg,
                     lower=lower, upper=upper, scale_dual=scale_dual,
                     scale_equality=scale_equality, scale_bound=scale_bound,
                     default_init=default_init)

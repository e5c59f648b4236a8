"""SIP-style interior-point solver for stagewise NLPs — built from scratch.

The reference delegates the outer loop to the external `@sip//sip` library,
visible only through its callback interface (reference:
sip_optimal_control.cpp:182-208): factor(w, r1, r2, r3), solve(b, sol), the
K/H/C/G matvec oracles, model_callback with `new_x` caching, box bounds,
residual scaling, and warm-startable (x, y) state.  This module implements
that solver as a single jitted `lax.while_loop`: no host control flow, per-scenario statuses as data, batching via `jax.vmap` over the whole
solve.

Method: slack-based primal-dual barrier with proximal (dual) regularization
— the scheme the regularized KKT operator of ops/kkt.py is designed for
(cf. PAPERS.md: "Dual-Regularized Riccati Recursions for Interior-Point
Optimal Control", arXiv 2509.16370):

  minimize f(v)  s.t.  c(v) = 0,  g(v) + s = 0,  s >= 0,  lb <= v <= ub,

with v = (x nodes, u edges, theta).  Each iteration solves

  [[H + r1, C^T, G^T], [C, -r2, 0], [G, 0, -(w + r3)]] (dv, dy, dz) = b,

with w = s / z (slack-eliminated primal-dual barrier row), r1 = prox +
bound-barrier diagonal zl/(v-lb) + zu/(ub-v) (bounds live on the primal
diagonal exactly as the reference's r1 channel implies), r2 = r3 = O(mu)
dual proximal regularization (this is what keeps the tree-LQR reduction
unconditionally factorizable).  Steps are globalized by a fraction-to-
boundary rule plus an Armijo backtracking line search on the barrier-merit
function; mu follows a monotone Fiacco-McCormick schedule.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..types import Dimensions, TopologySchedule
from ..ops.kkt import (ConstraintMasks, KKTVector, Regularizations,
                       StageModelData, apply_C, apply_CT, apply_G, apply_GT,
                       apply_H, apply_K, kkt_factor, kkt_solve,
                       zero_kkt_vector)
from .settings import Settings, SIPStatus

_EPS = 1e-300


# ---------------------------------------------------------------------------
# variable containers
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Primal:
    """Primal variables: node states, edge controls, global theta."""

    x: jax.Array      # [N, n]
    u: jax.Array      # [E, m]
    theta: jax.Array  # [p]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class YVec:
    """Equality (y) space: root+dynamics rows per node, node-c, edge-c rows.

    Flat layout equivalent (reference: types.cpp:43-53):
    [dyn_0, node_c_0, ..., dyn_E, node_c_E, edge_c_0, ...]."""

    dyn: jax.Array    # [N, n]
    nc: jax.Array     # [N, cn]
    ec: jax.Array     # [E, ce]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ZVec:
    """Inequality (z) space (reference layout: types.cpp:55-63)."""

    n: jax.Array      # [N, gn]
    e: jax.Array      # [E, ge]


def _tmap(f, *trees):
    return jax.tree.map(f, *trees)


def _tsum(tree) -> jax.Array:
    return sum(jnp.sum(l) for l in jax.tree.leaves(tree))


def _tinf(tree) -> jax.Array:
    leaves = [jnp.max(jnp.abs(l), initial=0.0) for l in jax.tree.leaves(tree)]
    return jnp.max(jnp.stack(leaves)) if leaves else jnp.asarray(0.0)


def _tdot(a, b) -> jax.Array:
    return sum(jnp.sum(x * y) for x, y in
               zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def _allfin(tree) -> jax.Array:
    return jnp.all(jnp.stack(
        [jnp.all(jnp.isfinite(l)) for l in jax.tree.leaves(tree)]))


class ModelEval(NamedTuple):
    """Everything the IPM needs at the current iterate.

    Mirrors the reference's model_callback contract
    (reference: sip_optimal_control.cpp:13-127): objective + gradient +
    stacked residuals + derivative/Hessian stage data.  The Hessian blocks
    in `stage` are Lagrangian Hessians at the given (y, z)."""

    f: jax.Array
    grad: Primal
    c: YVec           # assembled equality residuals (root row included)
    g: ZVec
    stage: StageModelData


@dataclasses.dataclass(frozen=True)
class OCProblem:
    """A trajectory-optimization problem instance (static part).

    The equivalent of the reference's Input (reference: types.hpp:128-151)
    with JAX callables instead of C callbacks.  `eval_model` is the full
    derivative evaluation; `eval_fcg` is the cheap residual-only evaluation
    used by line-search probes (the reference's `new_x=false` path)."""

    dims: Dimensions
    sched: TopologySchedule
    masks: ConstraintMasks
    eval_model: Callable[[Primal, YVec, ZVec], ModelEval]
    eval_fcg: Callable[[Primal], tuple]      # -> (f, c: YVec, g: ZVec)
    lower: Primal                            # -inf where unbounded
    upper: Primal                            # +inf where unbounded
    # Residual scalings multiply the convergence-test residuals.  Each is a
    # scalar float OR a per-element pytree, mirroring the reference's
    # ResidualScaling, whose dual/equality/variable_bound members are
    # per-element DOUBLE ARRAYS over the flat primal / equality layouts
    # (reference: types.hpp:144-148; real vectors wired in at
    # tests/variable_dimensions_test.cpp:421-427):
    #   scale_dual:     float | Primal  — stationarity (dual) residual rows
    #   scale_equality: float | YVec    — equality residual rows
    #   scale_bound:    float | Primal  — variable-bound complementarity
    #                    rows (a scalar additionally scales the slack s*z
    #                    complementarity, preserving the scalar-API
    #                    behavior; per-element bound scaling follows the
    #                    reference's x_dim-sized variable_bound array)
    scale_dual: object = 1.0
    scale_equality: object = 1.0
    scale_bound: object = 1.0
    # default primal initialization when solve() gets no warm start
    # (e.g. the constant-trajectory init built from initial_state)
    default_init: Optional["Primal"] = None


class SolveResult(NamedTuple):
    vars: Primal
    s: ZVec
    y: YVec
    z: ZVec
    zl: Primal
    zu: Primal
    f: jax.Array
    status: jax.Array         # int32 SIPStatus
    iterations: jax.Array
    kkt_error: jax.Array
    mu: jax.Array


class _IPMState(NamedTuple):
    vars: Primal
    s: ZVec
    y: YVec
    z: ZVec
    zl: Primal
    zu: Primal
    mu: jax.Array
    nu: jax.Array
    it: jax.Array
    status: jax.Array
    kkt_error: jax.Array
    # Levenberg-style multiplier on the primal proximal regularization.
    # Inflated when a factorization fails post-retries or the line search
    # exhausts its budget (the step is rejected, not applied); decays back
    # toward 1 after accepted steps (settings.reg_boost_*).
    reg_boost: jax.Array
    # consecutive rejected steps (drives the STALLED status)
    consec_rej: jax.Array
    # model evaluation AT the current iterate (vars, y, z).  Carrying it in
    # the loop state lets the body test convergence at the END of each step,
    # so a k-step solve costs k factor/solves instead of k+1 (the extra
    # trip existed only to discover convergence) and needs no post-loop
    # re-evaluation — the dominant saving for warm-started MPC re-solves.
    ev: ModelEval
    # filter line-search memory: (theta, phi) pairs, one slot per iteration
    filt_th: jax.Array
    filt_ph: jax.Array


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _pack_b(primal: Primal, yv: YVec, zv: ZVec, p: int,
            template: KKTVector) -> KKTVector:
    return KKTVector(x=primal.x, u=primal.u, theta=primal.theta,
                     y_dyn=yv.dyn, y_nc=yv.nc, y_ec=yv.ec,
                     z_n=zv.n, z_e=zv.e)


def _kkt_from_duals(template: KKTVector, y: YVec, z: ZVec) -> KKTVector:
    zero = jax.tree.map(jnp.zeros_like, template)
    return dataclasses.replace(zero, y_dyn=y.dyn, y_nc=y.nc, y_ec=y.ec,
                               z_n=z.n, z_e=z.e)


def _primal_of(v: KKTVector) -> Primal:
    return Primal(x=v.x, u=v.u, theta=v.theta)


def _y_of(v: KKTVector) -> YVec:
    return YVec(dyn=v.y_dyn, nc=v.y_nc, ec=v.y_ec)


def _z_of(v: KKTVector) -> ZVec:
    return ZVec(n=v.z_n, e=v.z_e)


def _zmasks(masks: ConstraintMasks) -> ZVec:
    return ZVec(n=jnp.asarray(masks.ng), e=jnp.asarray(masks.eg))


def _print_derivative_check(problem: "OCProblem", vars0: Primal, y: YVec,
                            z: ZVec, ev: ModelEval, template: KKTVector,
                            num_directions: int = 2) -> None:
    """In-graph finite-difference derivative check, printed at the initial
    iterate when settings.logging.print_derivative_check_logs is set.

    The reference's SIP core has the same built-in channel
    (reference: tests/variable_dimensions_test.cpp:432 sets
    settings.logging.print_derivative_check_logs).  Central differences of
    the residual-only evaluation along fixed random directions are compared
    against the model's gradient, C/G Jacobian operators and Lagrangian
    Hessian; fully traceable (constants baked at trace time), so it works
    under jit and vmap.  Expected magnitudes: ~eps^(2/3) of the problem
    scale for exact autodiff models; `hessian` is only meaningful in
    hessian_mode="exact"."""
    sched = problem.sched
    dtype = template.x.dtype
    eps = float(jnp.finfo(dtype).eps) ** (1.0 / 3.0)
    rng = np.random.default_rng(0)

    e_grad = jnp.asarray(0.0, dtype)
    e_c = jnp.asarray(0.0, dtype)
    e_g = jnp.asarray(0.0, dtype)
    e_h = jnp.asarray(0.0, dtype)
    for _ in range(num_directions):
        d = Primal(
            x=jnp.asarray(rng.standard_normal(template.x.shape), dtype),
            u=jnp.asarray(rng.standard_normal(template.u.shape), dtype),
            theta=jnp.asarray(rng.standard_normal(template.theta.shape),
                              dtype))
        vp = _tmap(lambda a, b_: a + eps * b_, vars0, d)
        vm = _tmap(lambda a, b_: a - eps * b_, vars0, d)
        fp, cp, gp = problem.eval_fcg(vp)
        fm, cm, gm = problem.eval_fcg(vm)

        e_grad = jnp.maximum(e_grad, jnp.abs(
            _tdot(ev.grad, d) - (fp - fm) / (2 * eps)))

        dk = dataclasses.replace(jax.tree.map(jnp.zeros_like, template),
                                 x=d.x, u=d.u, theta=d.theta)
        cd = apply_C(ev.stage, dk, sched)
        fd_c = _tmap(lambda a, b_: (a - b_) / (2 * eps), cp, cm)
        e_c = jnp.maximum(e_c, jnp.maximum(
            _tinf(YVec(dyn=cd.y_dyn - fd_c.dyn, nc=cd.y_nc - fd_c.nc,
                       ec=cd.y_ec - fd_c.ec)), 0.0))
        gd = apply_G(ev.stage, dk, sched)
        fd_g = _tmap(lambda a, b_: (a - b_) / (2 * eps), gp, gm)
        e_g = jnp.maximum(e_g, _tinf(ZVec(n=gd.z_n - fd_g.n,
                                          e=gd.z_e - fd_g.e)))

        # Lagrangian-Hessian check: H d vs central FD of the Lagrangian
        # gradient at fixed multipliers
        evp = problem.eval_model(vp, y, z)
        evm = problem.eval_model(vm, y, z)
        duals = _kkt_from_duals(template, y, z)

        def lag_grad(e):
            ct = apply_CT(e.stage, duals, sched)
            gt = apply_GT(e.stage, duals, sched)
            return Primal(x=e.grad.x + ct.x + gt.x,
                          u=e.grad.u + ct.u + gt.u,
                          theta=e.grad.theta + ct.theta + gt.theta)

        hd = apply_H(ev.stage, dk, sched)
        fd_h = _tmap(lambda a, b_: (a - b_) / (2 * eps), lag_grad(evp),
                     lag_grad(evm))
        e_h = jnp.maximum(e_h, _tinf(Primal(x=hd.x - fd_h.x,
                                            u=hd.u - fd_h.u,
                                            theta=hd.theta - fd_h.theta)))

    jax.debug.print(
        "derivative check (central FD, eps={eps:.2e}): gradient={g:.3e} "
        "jacobian_c={c:.3e} jacobian_g={gq:.3e} hessian={h:.3e}",
        eps=eps, g=e_grad, c=e_c, gq=e_g, h=e_h)


def solve(problem: OCProblem, settings: Settings,
          init_vars: Optional[Primal] = None,
          init_y: Optional[YVec] = None,
          init_z: Optional[ZVec] = None,
          init_zl: Optional[Primal] = None,
          init_zu: Optional[Primal] = None,
          coupled_axes: Optional[tuple] = None) -> SolveResult:
    """Run the interior-point solve.  Fully traceable; vmap over a leading
    batch axis of the arrays referenced by the problem's closures + inits
    for scenario batching.

    Warm starting: pass `init_vars` / `init_y` (and optionally the
    inequality multipliers `init_z` and bound duals `init_zl`/`init_zu`)
    from a previous SolveResult (the reference persists the whole
    sip_workspace.vars across re-solves the same way,
    reference: tests/variable_dimensions_test.cpp:437-446).
    Warm `init_z` is floored at mu_init complementarity (z >= mu/s) so a
    near-zero carried multiplier cannot pin its slack; warm bound duals
    are projected into the IPOPT-style kappa_sigma box
    [mu/(kappa d), kappa mu/d], which keeps a carried multiplier at an
    active bound (the cold init mu/d there is off by orders of
    magnitude).

    ``coupled_axes``: names of mapped axes (vmap axis_name and/or mesh
    axes) across which all lanes solve ONE joint problem sharing the
    global theta (SURVEY 2.10(c)).  Scalar couplings (merit, residual
    norms, step limits, line search) and the theta Schur system are
    reduced across these axes with psum/pmax/pmin, so the joint solve is
    mathematically identical to a single-device solve of the equivalent
    star tree; the stagewise factorizations stay lane-local.  Requires
    unbounded theta (box bounds on theta would add lane-replicated
    barrier terms this mode does not de-duplicate).

    When a mesh axis is among coupled_axes, the surrounding shard_map
    MUST be built with ``check_vma=False`` (jax 0.7's varying-axes
    checker cannot type collectives over a vmap axis nested inside
    shard_map; the collectives themselves are correct — see
    tests/test_joint_theta.py).  ``parallel.solve_joint_theta`` does
    this for you and is the recommended entry point."""
    if settings.fixed_iterations and settings.max_iterations < 1:
        # the degenerate 0-trip scan would skip the body entirely, where
        # the while_loop path always executes one trip (ADVICE r3)
        raise ValueError(
            "fixed_iterations requires max_iterations >= 1 (a 0-length "
            "scan would diverge from the while_loop semantics)")
    # Bake the matmul precision into every op traced below: reduced-
    # precision matmul passes cap the reachable KKT error on badly-scaled
    # problems (see Settings.matmul_precision).
    with jax.default_matmul_precision(settings.matmul_precision):
        return _solve_impl(problem, settings, init_vars, init_y, init_z,
                           init_zl, init_zu, coupled_axes)


def _solve_impl(problem: OCProblem, settings: Settings,
                init_vars, init_y, init_z, init_zl,
                init_zu, coupled_axes=None) -> SolveResult:
    dims = problem.dims
    masks = problem.masks
    sched = problem.sched
    dtype = jnp.result_type(float)
    zmask = _zmasks(masks)
    zmask_f = _tmap(lambda m: m.astype(dtype), zmask)
    pmask = Primal(x=jnp.asarray(masks.state, dtype),
                   u=jnp.asarray(masks.control, dtype),
                   theta=jnp.ones((dims.theta_dim,), dtype))
    template = zero_kkt_vector(dims, dtype)
    lower, upper = problem.lower, problem.upper
    has_lb = _tmap(jnp.isfinite, lower)
    has_ub = _tmap(jnp.isfinite, upper)
    ls = settings.line_search

    # ----- coupled (shared-theta) reductions -------------------------------
    # With coupled_axes set, every lane of the mapped axes is one scenario
    # of a single joint NLP sharing the global theta: scalar couplings are
    # psum/pmax/pmin-reduced, lane-replicated theta terms (prox reg) are
    # counted exactly once via a lane-0 indicator, and kkt_factor/kkt_solve
    # psum the theta Schur pieces (SURVEY 2.10(c)).
    coupled = tuple(coupled_axes) if coupled_axes else ()
    if coupled:
        try:
            th_lo = np.asarray(lower.theta)
            th_up = np.asarray(upper.theta)
            if np.any(np.isfinite(th_lo)) or np.any(np.isfinite(th_up)):
                raise ValueError(
                    "coupled_axes requires unbounded theta (theta box "
                    "bounds would add lane-replicated barrier terms)")
        except ValueError:
            raise
        except Exception:
            pass  # traced bounds: trust the caller
        def _fold(op):
            # One collective per axis: a SINGLE psum over mixed vmap +
            # mesh axis names is rejected outright by jax 0.7.  NOTE
            # this fold alone is NOT sufficient under shard_map: the
            # varying-axes checker still cannot type a collective over a
            # vmap axis nested inside shard_map, so any shard_map around
            # a coupled solve must pass check_vma=False (as
            # parallel.solve_joint_theta does).
            def red(v):
                for ax in coupled:
                    v = op(v, ax)
                return v
            return red
        gsum = _fold(lax.psum)
        gmax = _fold(lax.pmax)
        gmin = _fold(lax.pmin)
        rep0_flag = jnp.asarray(True)
        for ax in coupled:
            rep0_flag = rep0_flag & (lax.axis_index(ax) == 0)
        rep0 = rep0_flag.astype(dtype)                 # 1 on global lane 0
    else:
        gsum = gmax = gmin = lambda v: v               # noqa: E731
        rep0 = jnp.asarray(1.0, dtype)

    def dist_l(vars):
        return _tmap(lambda v, lb, h: jnp.where(h, v - lb, 1.0),
                     vars, lower, has_lb)

    def dist_u(vars):
        return _tmap(lambda v, ub, h: jnp.where(h, ub - v, 1.0),
                     vars, upper, has_ub)

    # ----- initialization --------------------------------------------------
    # explicit warm starts get only a tiny interior push so saturated
    # variables stay (numerically) at their bounds across MPC re-solves
    # (VERDICT r1 item 8); cold starts keep the standard kappa_1-style push
    push_eps = (settings.warm_bound_push if init_vars is not None
                else settings.bound_push)
    if init_vars is None:
        init_vars = problem.default_init
    if init_vars is None:
        init_vars = Primal(
            x=jnp.zeros_like(template.x), u=jnp.zeros_like(template.u),
            theta=jnp.zeros_like(template.theta))
    # push strictly inside the bounds (cf. IPOPT's kappa_1 push)
    def push(v, lb, ub, hl, hu):
        lo = jnp.where(hl, lb + push_eps *
                       jnp.maximum(1.0, jnp.abs(lb)), -jnp.inf)
        hi = jnp.where(hu, ub - push_eps *
                       jnp.maximum(1.0, jnp.abs(ub)), jnp.inf)
        mid = jnp.where(hl & hu, 0.5 * (lb + ub), 0.0)
        v = jnp.where(lo <= hi, jnp.clip(v, lo, hi), mid)
        return v
    vars0 = _tmap(push, init_vars, lower, upper, has_lb, has_ub)
    vars0 = _tmap(lambda v, m: v * m, vars0, pmask)

    f0, c0, g0 = problem.eval_fcg(vars0)
    # A zero derived from traced data: keeps while_loop carries "varying"
    # under shard_map (constants entering a carry that becomes
    # device-varying trip the vma check).
    vzero = jnp.zeros_like(f0)
    mu0 = jnp.asarray(settings.mu_init, dtype) + vzero
    s0 = _tmap(lambda g, m: jnp.where(
        m, jnp.maximum(-g, settings.mu_init), 1.0), g0, zmask)
    if init_z is not None:
        # carried inequality multipliers, floored at mu/s complementarity
        z0 = _tmap(lambda zw, s, m: jnp.where(
            m, jnp.maximum(zw, mu0 / jnp.maximum(s, _EPS)), 1.0),
            init_z, s0, zmask)
    else:
        z0 = _tmap(lambda s, m: jnp.where(m, mu0 / s, 1.0), s0, zmask)
    y0 = init_y if init_y is not None else YVec(
        dyn=jnp.zeros_like(template.y_dyn),
        nc=jnp.zeros_like(template.y_nc),
        ec=jnp.zeros_like(template.y_ec))
    kappa_s = settings.kappa_sigma

    def bound_dual_init(warm, dists, has):
        if warm is None:
            return _tmap(lambda d, h: jnp.where(h, mu0 / d, 0.0), dists,
                         has)
        return _tmap(
            lambda zw, d, h: jnp.where(
                h, jnp.clip(zw, mu0 / (kappa_s * jnp.maximum(d, _EPS)),
                            kappa_s * mu0 / jnp.maximum(d, _EPS)), 0.0),
            warm, dists, has)

    zl0 = bound_dual_init(init_zl, dist_l(vars0), has_lb)
    zu0 = bound_dual_init(init_zu, dist_u(vars0), has_ub)

    state0 = _IPMState(
        vars=vars0, s=s0, y=y0, z=z0, zl=zl0, zu=zu0, mu=mu0,
        nu=jnp.asarray(ls.nu_min, dtype) + vzero,
        it=jnp.int32(0) + vzero.astype(jnp.int32),
        status=jnp.int32(SIPStatus.RUNNING) + vzero.astype(jnp.int32),
        kkt_error=jnp.asarray(jnp.inf, dtype) + vzero,
        reg_boost=jnp.asarray(1.0, dtype) + vzero,
        consec_rej=jnp.int32(0) + vzero.astype(jnp.int32),
        ev=None,  # filled below
        filt_th=jnp.full((settings.max_iterations,), jnp.inf, dtype),
        filt_ph=jnp.full((settings.max_iterations,), jnp.inf, dtype))

    # ----- residuals and errors -------------------------------------------
    def kkt_residuals(vars, s, y, z, zl, zu, ev: ModelEval):
        duals = _kkt_from_duals(template, y, z)
        ct = apply_CT(ev.stage, duals, sched)
        gt = apply_GT(ev.stage, duals, sched)
        stat = _tmap(lambda g_, a, b_, l, u_, m: (g_ + a + b_ + u_ - l) * m,
                     ev.grad, _primal_of(ct), _primal_of(gt), zl, zu, pmask)
        if coupled:
            # joint stationarity in theta = sum of lane contributions
            # (theta is unbounded here, so zl/zu theta rows are zero)
            stat = dataclasses.replace(stat, theta=gsum(stat.theta))
        r_ineq = _tmap(lambda g, sv, m: jnp.where(m, g + sv, 0.0), ev.g, s,
                       zmask)
        # Per-element (or scalar) residual scalings (reference:
        # ResidualScaling double arrays, types.hpp:144-148).
        def _is_scalar_scale(s_):
            # Python/numpy/jnp scalars all scale the norm directly;
            # anything else is a per-element pytree
            return isinstance(s_, (int, float)) or (
                hasattr(s_, "ndim") and s_.ndim == 0)

        def scaled_inf(tree, scale):
            if _is_scalar_scale(scale):
                return scale * _tinf(tree)
            return _tinf(_tmap(lambda a, s_: a * s_, tree, scale))

        sb = problem.scale_bound
        sb_scalar = _is_scalar_scale(sb)

        # complementarity at barrier parameter value `m_mu`
        def comp(m_mu):
            cs = _tmap(lambda sv, zv, m: jnp.where(m, sv * zv - m_mu, 0.0),
                       s, z, zmask)
            cl = _tmap(lambda d, l, h: jnp.where(h, d * l - m_mu, 0.0),
                       dist_l(vars), zl, has_lb)
            cu = _tmap(lambda d, u_, h: jnp.where(h, d * u_ - m_mu, 0.0),
                       dist_u(vars), zu, has_ub)
            cs_err = (sb * _tinf(cs)) if sb_scalar else _tinf(cs)
            return jnp.maximum(cs_err, jnp.maximum(scaled_inf(cl, sb),
                                                   scaled_inf(cu, sb)))

        def err(m_mu):
            return gmax(jnp.max(jnp.stack([
                scaled_inf(stat, problem.scale_dual),
                scaled_inf(ev.c, problem.scale_equality),
                _tinf(r_ineq),
                comp(m_mu)])))

        return stat, r_ineq, err

    # evaluate the model at the initial iterate and classify it (SOLVED /
    # DIVERGED warm starts never enter the loop)
    with jax.named_scope("model_eval"):
        ev0 = problem.eval_model(vars0, y0, z0)
    if settings.logging.print_derivative_check_logs:
        # the reference's derivative-check channel
        # (reference: tests/variable_dimensions_test.cpp:432)
        _print_derivative_check(problem, vars0, y0, z0, ev0, template)
    if settings.debug_check_finite:
        lax.cond(
            _allfin(vars0) & _allfin((ev0.f, ev0.grad, ev0.c, ev0.g)),
            lambda: None,
            lambda: jax.debug.print(
                "NONFINITE at initial iterate: vars_ok={v} model_ok={m}",
                v=_allfin(vars0),
                m=_allfin((ev0.f, ev0.grad, ev0.c, ev0.g))))
    _, _, err0_fn = kkt_residuals(vars0, s0, y0, z0, zl0, zu0, ev0)
    e0_init = err0_fn(0.0)
    status_init = jnp.where(
        e0_init <= settings.tol, jnp.int32(SIPStatus.SOLVED),
        jnp.where(~jnp.isfinite(e0_init)
                  | (e0_init > settings.diverged_kkt),
                  jnp.int32(SIPStatus.DIVERGED),
                  jnp.int32(SIPStatus.RUNNING)))
    state0 = state0._replace(ev=ev0, kkt_error=e0_init, status=status_init)
    # propagate varying-ness to every carry leaf (see vzero note above)
    state0 = jax.tree.map(lambda a: a + vzero.astype(a.dtype), state0)

    # ----- merit function --------------------------------------------------
    def barrier_value(vars, s, f, c, g, mu, nu):
        log_s = _tsum(_tmap(
            lambda sv, m: jnp.where(m, jnp.log(jnp.maximum(sv, _EPS)), 0.0),
            s, zmask))
        log_b = _tsum(_tmap(
            lambda d, h: jnp.where(h, jnp.log(jnp.maximum(d, _EPS)), 0.0),
            dist_l(vars), has_lb)) + _tsum(_tmap(
                lambda d, h: jnp.where(h, jnp.log(jnp.maximum(d, _EPS)), 0.0),
                dist_u(vars), has_ub))
        theta = _tsum(_tmap(jnp.abs, c)) + _tsum(
            _tmap(lambda gv, sv, m: jnp.where(m, jnp.abs(gv + sv), 0.0),
                  g, s, zmask))
        base = f - mu * (log_s + log_b)
        if coupled:
            # joint merit = sum over all scenario lanes (theta is
            # unbounded, so no lane-replicated barrier term to de-dup)
            base, theta = gsum(base), gsum(theta)
        return base + nu * theta, theta

    # ----- one IPM iteration ----------------------------------------------
    def body(st: _IPMState) -> _IPMState:
        vars, s, y, z, zl, zu, mu = (st.vars, st.s, st.y, st.z, st.zl,
                                     st.zu, st.mu)
        # the model evaluation at the current iterate is carried in the
        # state (computed at the end of the previous step); the body only
        # runs on iterates already classified RUNNING
        ev = st.ev
        stat, r_ineq, err_fn = kkt_residuals(vars, s, y, z, zl, zu, ev)
        e0 = st.kkt_error

        # barrier update (possibly several decreases handled across iters)
        e_mu = err_fn(mu)
        shrink = e_mu <= settings.kappa_eps * mu
        mu = jnp.where(
            shrink,
            jnp.maximum(settings.mu_min,
                        jnp.minimum(settings.kappa_mu * mu,
                                    mu ** settings.theta_mu)),
            mu)

        dl, du = dist_l(vars), dist_u(vars)
        # regularizations: w = s/z; bounds fold into r1
        # (reference channels: factor(w, r1, r2, r3), helpers.cpp:242)
        reg_d = settings.gamma_reg * mu + settings.reg_floor
        bound_diag = _tmap(
            lambda d1, l, h1, d2, u_, h2: jnp.where(h1, l / d1, 0.0)
            + jnp.where(h2, u_ / d2, 0.0),
            dl, zl, has_lb, du, zu, has_ub)
        r1 = _tmap(lambda b_, m: (settings.prox_reg * st.reg_boost + b_) * m,
                   bound_diag, pmask)
        if coupled:
            # the global theta's prox regularization is ONE term of the
            # joint system: count it on global lane 0 only (the psum in
            # kkt_factor then adds it exactly once)
            r1 = dataclasses.replace(r1, theta=r1.theta * rep0)
        w = _tmap(lambda sv, zv, m: jnp.where(m, sv / zv, 1.0), s, z, zmask)
        regs = Regularizations(
            w_n=w.n, w_e=w.e, r1_x=r1.x, r1_u=r1.u, r1_th=r1.theta,
            r2_dyn=jnp.full_like(template.y_dyn, reg_d),
            r2_nc=jnp.full_like(template.y_nc, reg_d),
            r2_ec=jnp.full_like(template.y_ec, reg_d),
            r3_n=jnp.full_like(template.z_n, reg_d),
            r3_e=jnp.full_like(template.z_e, reg_d))

        # Newton RHS: primal row uses the primal-barrier bound gradient
        duals = _kkt_from_duals(template, y, z)
        ct = apply_CT(ev.stage, duals, sched)
        gt = apply_GT(ev.stage, duals, sched)
        bound_grad = _tmap(
            lambda d1, h1, d2, h2: -jnp.where(h1, mu / d1, 0.0)
            + jnp.where(h2, mu / d2, 0.0), dl, has_lb, du, has_ub)
        b_x = _tmap(lambda g_, a, b_, bg, m: -(g_ + a + b_ + bg) * m,
                    ev.grad, _primal_of(ct), _primal_of(gt), bound_grad,
                    pmask)
        b_y = _tmap(jnp.negative, ev.c)
        b_z = _tmap(lambda gv, zv, m: jnp.where(m, -gv - mu / zv, 0.0),
                    ev.g, z, zmask)
        b = _pack_b(b_x, b_y, b_z, dims.theta_dim, template)

        # factor with bounded proximal-inflation retries
        rbackend = (settings.riccati_backend if sched.topology.is_chain
                    else "scan")

        def gfactor(regs_):
            # coupled mode: a joint factorization fails when ANY lane's
            # does (all lanes must retry/reject together — they share one
            # Newton system)
            with jax.named_scope("newton_step"):
                f_ = kkt_factor(ev.stage, regs_, masks, sched, rbackend,
                                axis_names=coupled)
            return f_._replace(status=gmax(f_.status)) if coupled else f_

        fact0 = gfactor(regs)

        def retry_cond(carry):
            regs_c, fact_c, k = carry
            return (fact_c.status != 0) & (k < settings.max_factor_retries)

        def retry_body(carry):
            regs_c, fact_c, k = carry
            regs_n = dataclasses.replace(
                regs_c,
                r1_x=regs_c.r1_x * settings.retry_scale
                + settings.retry_scale * settings.prox_reg * pmask.x,
                r1_u=regs_c.r1_u * settings.retry_scale
                + settings.retry_scale * settings.prox_reg * pmask.u,
                r1_th=regs_c.r1_th * settings.retry_scale
                + settings.retry_scale * settings.prox_reg * pmask.theta
                * (rep0 if coupled else 1.0))
            return (regs_n, gfactor(regs_n), k + 1)

        if settings.max_factor_retries > 0:
            regs_f, fact, _ = lax.while_loop(
                retry_cond, retry_body,
                (regs, fact0, jnp.int32(0) + 0 * fact0.status))
        else:
            # retries disabled: skip the while wrapper entirely (its carry
            # boundary costs a copy of the whole factorization every
            # iteration even when no retry ever fires); a failed factor
            # becomes a rejected step + reg boost, retried next iteration
            regs_f, fact = regs, fact0
        factor_failed = fact.status != 0

        with jax.named_scope("newton_step"):
            sol = kkt_solve(fact, ev.stage, b, sched, rbackend,
                            axis_names=coupled)
        for _ in range(settings.iterative_refinement_steps):
            # coupled note: apply_K's theta row returns this lane's
            # contribution (regs_f.r1_th is lane-0 masked), so resid.theta
            # stays a lane-local contribution — kkt_solve's psum then
            # reduces it exactly like the original b.theta
            resid = b - apply_K(ev.stage, regs_f, sol, sched)
            sol = sol + kkt_solve(fact, ev.stage, resid, sched, rbackend,
                                  axis_names=coupled)
        dv = _primal_of(sol)
        dy = _y_of(sol)
        dz = _z_of(sol)
        ds = _tmap(lambda ri, gdx, m: jnp.where(m, -ri - gdx, 0.0),
                   r_ineq, _z_of(apply_G(ev.stage, sol, sched)), zmask)
        dzl = _tmap(lambda d, l, dx_, h: jnp.where(
            h, mu / d - l - (l / d) * dx_, 0.0), dl, zl, dv, has_lb)
        dzu = _tmap(lambda d, u_, dx_, h: jnp.where(
            h, mu / d - u_ + (u_ / d) * dx_, 0.0), du, zu, dv, has_ub)

        # A failed factorization's direction is garbage: zero it (jnp.where
        # also scrubs NaNs), so this iteration becomes a rejected step and
        # the reg boost below retries with heavier regularization instead of
        # poisoning the iterate (VERDICT r1 weak #5 / item 9).
        def _scrub(t):
            return _tmap(lambda a: jnp.where(factor_failed,
                                             jnp.zeros_like(a), a), t)
        dv, dy, dz, ds, dzl, dzu = (_scrub(dv), _scrub(dy), _scrub(dz),
                                    _scrub(ds), _scrub(dzl), _scrub(dzu))

        # fraction-to-boundary step limits
        tau = jnp.maximum(settings.tau_min, 1.0 - mu)

        def max_step(val, dval, mask):
            # max alpha <= 1 with val + alpha*dval >= (1-tau)*val
            bad = mask & (dval < 0)
            a = jnp.where(bad, -tau * val / jnp.where(bad, dval, -1.0), 1.0)
            return jnp.min(a, initial=1.0)

        alpha_p = gmin(jnp.minimum(
            jnp.min(jnp.stack([max_step(sv, dsv, m) for sv, dsv, m in zip(
                jax.tree.leaves(s), jax.tree.leaves(ds),
                jax.tree.leaves(zmask))]), initial=1.0) if
            jax.tree.leaves(s) else 1.0,
            jnp.minimum(
                jnp.min(jnp.stack(
                    [max_step(d, dd, h) for d, dd, h in zip(
                        jax.tree.leaves(dl), jax.tree.leaves(dv),
                        jax.tree.leaves(has_lb))]), initial=1.0),
                jnp.min(jnp.stack(
                    [max_step(d, -dd, h) for d, dd, h in zip(
                        jax.tree.leaves(du), jax.tree.leaves(dv),
                        jax.tree.leaves(has_ub))]), initial=1.0))))
        alpha_d = gmin(jnp.min(jnp.stack(
            [max_step(a, b_, m) for a, b_, m in zip(
                jax.tree.leaves(z) + jax.tree.leaves(zl)
                + jax.tree.leaves(zu),
                jax.tree.leaves(dz) + jax.tree.leaves(dzl)
                + jax.tree.leaves(dzu),
                jax.tree.leaves(zmask) + jax.tree.leaves(has_lb)
                + jax.tree.leaves(has_ub))]), initial=1.0))

        # ----- Armijo backtracking on the barrier merit function ----------
        phi0, theta0 = barrier_value(vars, s, ev.f, ev.c, ev.g, mu, 0.0)
        # directional derivative of f + barrier
        d_phi = gsum(_tdot(ev.grad, dv)
                     - mu * _tsum(_tmap(
                         lambda dsv, sv, m: jnp.where(m, dsv / sv, 0.0),
                         ds, s, zmask))
                     - mu * _tsum(_tmap(
                         lambda dx_, d, h: jnp.where(h, dx_ / d, 0.0),
                         dv, dl, has_lb))
                     + mu * _tsum(_tmap(
                         lambda dx_, d, h: jnp.where(h, dx_ / d, 0.0),
                         dv, du, has_ub)))
        nu = jnp.maximum(st.nu, jnp.where(
            theta0 > 1e-14, d_phi / ((1.0 - ls.nu_rho)
                                     * jnp.maximum(theta0, 1e-14)),
            ls.nu_min))
        nu = jnp.maximum(nu, ls.nu_min)
        slope = d_phi - nu * theta0
        phi0 = phi0 + nu * theta0

        def trial(alpha):
            vars_t = _tmap(lambda v_, d_: v_ + alpha * d_, vars, dv)
            s_t = _tmap(lambda sv, dsv: sv + alpha * dsv, s, ds)
            f_t, c_t, g_t = problem.eval_fcg(vars_t)
            phi_t, _ = barrier_value(vars_t, s_t, f_t, c_t, g_t, mu, nu)
            return vars_t, s_t, f_t, phi_t

        def ls_cond(carry):
            alpha, k, accepted = carry
            return (~accepted) & (k < ls.max_steps)

        # chunked backtracking: each trip tests `chunk` candidates
        # [alpha, alpha*bt, ..., alpha*bt^(chunk-1)] in ONE vectorized
        # probe and selects the largest passing one — same accepted alpha
        # as the sequential search, ceil(depth/chunk) trips instead of
        # depth (the vmapped loop runs to the batch max; see
        # LineSearchSettings.chunk)
        chunk = max(1, int(ls.chunk))
        bt = jnp.asarray(ls.backtrack, dtype)

        def _chunked(alpha, k, acceptable):
            """One trip: test the chunk of candidates below `alpha` with
            `acceptable(alpha_vec) -> ok_vec`; returns (alpha_next, ok).
            Candidates are built by ITERATED multiplication in dtype
            (bitwise-identical to the sequential chunk=1 search for any
            backtrack factor), and candidates past the max_steps trial
            budget are masked out so the accepted alpha never depends on
            whether chunk divides max_steps (ADVICE r2)."""
            cands = [alpha]
            for _ in range(chunk - 1):
                cands.append(cands[-1] * bt)
            alphas = jnp.stack(cands)
            with jax.named_scope("line_search"):
                oks = acceptable(alphas) & ((k + jnp.arange(chunk))
                                            < ls.max_steps)
            any_ok = jnp.any(oks)
            sel = alphas[jnp.argmax(oks)]  # first True = largest alpha
            return jnp.where(any_ok, sel, alphas[-1] * bt), any_ok

        if ls.use_filter_line_search:
            # Waechter-Biegler-style filter: accept a trial not dominated by
            # any remembered (theta, phi) pair and improving on the current
            # pair (or satisfying Armijo on phi for f-type steps).
            phi_bar0, _ = barrier_value(vars, s, ev.f, ev.c, ev.g, mu, 0.0)

            def filter_trial(alpha):
                vars_t = _tmap(lambda v_, d_: v_ + alpha * d_, vars, dv)
                s_t = _tmap(lambda sv, dsv: sv + alpha * dsv, s, ds)
                f_t, c_t, g_t = problem.eval_fcg(vars_t)
                phi_t, theta_t = barrier_value(vars_t, s_t, f_t, c_t, g_t,
                                               mu, 0.0)
                not_dom = jnp.all(
                    (theta_t <= (1.0 - ls.gamma_theta) * st.filt_th)
                    | (phi_t <= st.filt_ph - ls.gamma_phi * st.filt_th))
                progress = ((theta_t <= (1.0 - ls.gamma_theta) * theta0)
                            | (phi_t <= phi_bar0 - ls.gamma_phi * theta0))
                armijo = phi_t <= phi_bar0 + ls.eta * alpha * d_phi
                return not_dom & (progress | armijo)

            def fls_body(carry):
                alpha, k, _ = carry
                alpha_n, ok = _chunked(alpha, k, jax.vmap(filter_trial))
                return (alpha_n, k + chunk, ok)

            ls_init = (alpha_p + 0.0 * phi0, jnp.int32(0), phi0 != phi0)
            if chunk >= ls.max_steps:
                # one chunk covers the whole budget: the while_loop would
                # run exactly one trip — call the body directly and skip
                # the loop wrapper's carry boundary.  NaN phi0 (the init's
                # accepted flag) must still reproduce the loop's zero-trip
                # semantics: keep the init state on those lanes.
                alpha_b, _, acc_b = fls_body(ls_init)
                nan0 = phi0 != phi0
                alpha = jnp.where(nan0, ls_init[0], alpha_b)
                accepted = nan0 | acc_b
            else:
                alpha, _, accepted = lax.while_loop(ls_cond, fls_body,
                                                    ls_init)
            # augment the filter with the current pair (theta-type step) —
            # only when the step was actually taken
            filt_th_n = jnp.where(
                accepted,
                st.filt_th.at[st.it].set((1.0 - ls.gamma_theta) * theta0),
                st.filt_th)
            filt_ph_n = jnp.where(
                accepted,
                st.filt_ph.at[st.it].set(phi_bar0 - ls.gamma_phi * theta0),
                st.filt_ph)
        else:
            def armijo_ok(alphas):
                phis = jax.vmap(lambda a: trial(a)[3])(alphas)
                return phis <= phi0 + ls.eta * alphas * slope

            def ls_body(carry):
                alpha, k, _ = carry
                alpha_n, ok = _chunked(alpha, k, armijo_ok)
                return (alpha_n, k + chunk, ok)

            ls_init = (alpha_p + 0.0 * phi0, jnp.int32(0), phi0 != phi0)
            if chunk >= ls.max_steps:
                # single-trip budget: skip the while wrapper, preserving
                # the loop's zero-trip semantics on NaN-phi0 lanes (see
                # filter branch)
                alpha_b, _, acc_b = ls_body(ls_init)
                nan0 = phi0 != phi0
                alpha = jnp.where(nan0, ls_init[0], alpha_b)
                accepted = nan0 | acc_b
            else:
                alpha, _, accepted = lax.while_loop(ls_cond, ls_body,
                                                    ls_init)
            filt_th_n, filt_ph_n = st.filt_th, st.filt_ph

        # Min-alpha safeguard: an exhausted line search REJECTS the step
        # (alpha = 0, duals frozen) and inflates the carried regularization
        # boost, rather than applying an arbitrarily small alpha
        # (VERDICT r1 item 9).
        alpha = jnp.where(accepted, alpha, jnp.zeros_like(alpha))
        # duals still step on a rejected primal step (they are not merit
        # variables; the multiplier update re-centers the next KKT system —
        # and a failed factorization's directions were scrubbed to zero
        # above, so nothing moves in that case)
        alpha_d_eff = alpha_d
        step_rejected = factor_failed | ~accepted
        reg_boost_n = jnp.where(
            step_rejected,
            jnp.minimum(st.reg_boost * settings.reg_boost_scale,
                        settings.reg_boost_max),
            jnp.maximum(st.reg_boost * settings.reg_boost_decay, 1.0))
        consec_rej_n = jnp.where(step_rejected, st.consec_rej + 1,
                                 jnp.zeros_like(st.consec_rej))

        # accepted iterate: the bare update arithmetic only — trial()'s
        # eval_fcg would be wholly redundant here (eval_model below
        # recomputes f, c, g at vars_n anyway; measured ~1.5 ms/batch per
        # eval_fcg at the headline config, so this was a full extra
        # model-residual pass per IPM iteration)
        vars_n = _tmap(lambda v_, d_: v_ + alpha * d_, vars, dv)
        s_n = _tmap(lambda sv, dsv: sv + alpha * dsv, s, ds)
        y_n = _tmap(lambda a, d_: a + alpha_d_eff * d_, y, dy)
        z_n = _tmap(lambda a, d_, m: jnp.where(m, a + alpha_d_eff * d_, 1.0),
                    z, dz, zmask)
        zl_n = _tmap(lambda a, d_, h: jnp.where(h, a + alpha_d_eff * d_, 0.0),
                     zl, dzl, has_lb)
        zu_n = _tmap(lambda a, d_, h: jnp.where(h, a + alpha_d_eff * d_, 0.0),
                     zu, dzu, has_ub)
        # z-corridor safeguard (IPOPT's kappa_sigma reset)
        z_n = _tmap(lambda zv, sv, m: jnp.where(
            m, jnp.clip(zv, mu / (settings.kappa_sigma * sv),
                        settings.kappa_sigma * mu / sv), 1.0),
            z_n, s_n, zmask)
        s_n = _tmap(lambda sv, m: jnp.where(
            m, jnp.maximum(sv, settings.slack_min), 1.0), s_n, zmask)

        if settings.logging.print_logs:
            jax.debug.print(
                "it={it} f={f:.6e} E0={e0:.3e} mu={mu:.1e} "
                "alpha={al:.2e} alphad={ad:.2e} nu={nu:.1e} st={fs}",
                it=st.it, f=ev.f, e0=e0, mu=st.mu, al=alpha, ad=alpha_d,
                nu=nu, fs=fact.status)
        if settings.logging.print_search_direction_logs:
            jax.debug.print(
                "  dir: |dx|={dx:.3e} |dy|={dy:.3e} |dz|={dz:.3e} "
                "alpha_max={am:.3e} retries_status={fs}",
                dx=_tinf(dv), dy=_tinf(dy), dz=_tinf(dz), am=alpha_p,
                fs=fact.status)
        if settings.logging.print_line_search_logs:
            jax.debug.print(
                "  ls: alpha={al:.3e} phi0={p0:.6e} slope={sl:.3e} "
                "theta0={th:.3e} nu={nu:.2e}",
                al=alpha, p0=phi0, sl=slope, th=theta0, nu=nu)

        it_n = st.it + 1

        # evaluate the model at the ACCEPTED iterate and classify it; the
        # loop exits without a wasted factor/solve trip and without a
        # post-loop re-evaluation
        with jax.named_scope("model_eval"):
            ev_n = problem.eval_model(vars_n, y_n, z_n)
        # constant/empty leaves of a fresh ModelEval are not device-varying,
        # but the carried st.ev is; re-mark them (same vzero trick as state0)
        # so the while_loop carry types match under shard_map.
        ev_n = jax.tree.map(lambda a: a + vzero.astype(a.dtype), ev_n)
        _, _, err_n_fn = kkt_residuals(vars_n, s_n, y_n, z_n, zl_n, zu_n,
                                       ev_n)
        e_new = err_n_fn(0.0)
        # non-finite KKT error (NaN/inf iterates) counts as divergence: NaN
        # compares false everywhere, so without this the scenario would spin
        # to MAX_ITERATIONS doing useless work
        blew_up = ~jnp.isfinite(e_new) | (e_new > settings.diverged_kkt)
        # FACTORIZATION_FAILURE is terminal only once the regularization
        # boost is saturated — before that, rejected iterations retry with
        # heavier regularization
        gave_up = factor_failed & (st.reg_boost >= settings.reg_boost_max)
        if settings.debug_check_finite:
            # sanitizer-style NaN/inf tripwire (debug mode; see Settings)
            vars_ok = _allfin(vars_n)
            model_ok = _allfin((ev_n.f, ev_n.grad, ev_n.c, ev_n.g))
            duals_ok = _allfin((y_n, z_n, zl_n, zu_n, s_n))
            lax.cond(
                vars_ok & model_ok & duals_ok & jnp.isfinite(e_new),
                lambda: None,
                lambda: jax.debug.print(
                    "NONFINITE at it={it}: vars_ok={v} model_ok={m} "
                    "duals_ok={d} kkt_error={k:.3e} alpha={a:.2e} "
                    "mu={mu:.1e}", it=st.it, v=vars_ok, m=model_ok,
                    d=duals_ok, k=e_new, a=alpha, mu=mu))

        stalled = consec_rej_n >= settings.max_consecutive_rejections
        new_status = jnp.where(
            e_new <= settings.tol, jnp.int32(SIPStatus.SOLVED),
            jnp.where(gave_up,
                      jnp.int32(SIPStatus.FACTORIZATION_FAILURE),
                      jnp.where(blew_up, jnp.int32(SIPStatus.DIVERGED),
                                jnp.where(
                                    stalled, jnp.int32(SIPStatus.STALLED),
                                    jnp.where(
                                        it_n >= settings.max_iterations,
                                        jnp.int32(SIPStatus.MAX_ITERATIONS),
                                        jnp.int32(SIPStatus.RUNNING))))))

        return _IPMState(
            vars=vars_n, s=s_n, y=y_n, z=z_n, zl=zl_n, zu=zu_n,
            mu=mu, nu=nu, it=it_n, status=new_status, kkt_error=e_new,
            reg_boost=reg_boost_n, consec_rej=consec_rej_n, ev=ev_n,
            filt_th=filt_th_n, filt_ph=filt_ph_n)

    def cond(st: _IPMState):
        return st.status == SIPStatus.RUNNING

    if settings.fixed_iterations:
        # Real-time-iteration mode: exactly max_iterations trips as a scan
        # (static trip count, no convergence test between trips).  The
        # explicit select below reproduces the while_loop's vmap semantics
        # (lanes whose cond is False recompute but keep their old state),
        # so results per scenario are identical whenever the scenario
        # terminates within the budget; see Settings.fixed_iterations.
        #
        # The whole-state select is the default: it fuses into the
        # producers, and special-casing ev can disrupt the scan's buffer
        # reuse (Settings.rti_freeze_ev makes it a choice).
        def scan_body(st, _):
            new = body(st)
            keep = cond(st)
            if not settings.rti_freeze_ev:
                # exclude the (large) carried ModelEval from the freeze
                # select: frozen lanes keep their iterate/duals/statuses
                # (selected below) but carry a post-freeze ev — harmless
                # for every consumed output except SolveResult.f on
                # frozen lanes (see Settings.rti_freeze_ev)
                ev_n = new.ev
                new = new._replace(ev=st.ev)
            st_n = _tmap(lambda a, b: jnp.where(keep, a, b), new, st)
            if not settings.rti_freeze_ev:
                st_n = st_n._replace(ev=ev_n)
            return st_n, None

        final, _ = lax.scan(scan_body, state0, None,
                            length=settings.max_iterations)
    else:
        final = lax.while_loop(cond, body, state0)
    f_final = final.ev.f

    status = jnp.where(final.status == SIPStatus.RUNNING,
                       jnp.int32(SIPStatus.MAX_ITERATIONS), final.status)

    return SolveResult(
        vars=final.vars, s=final.s, y=final.y, z=final.z, zl=final.zl,
        zu=final.zu, f=f_final, status=status, iterations=final.it,
        kkt_error=final.kkt_error, mu=final.mu)

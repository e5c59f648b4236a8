"""Benchmark harness: batched MPC solves/s/chip at horizon 50.

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}
plus auditable quality stats (solved_frac, mean_iterations, max_kkt_error),
an analytic FLOP/byte estimate, and the device it ran on (platform,
device_kind, device_count).
Baseline target (BASELINE.md): >= 10,000 batched MPC solves/s/chip.

Workload: a batch of receding-horizon controllers (default: cartpole
swing-up, horizon 50, box input constraints, float32) driven by a fixed-seed
plant disturbance (--noise, DEFAULT ON at 0.05) so every timed re-solve does
real Newton work off the steady state.  The warm program itself (started
from constant trajectories) performs the untimed cold phase; the timed
region scans --steps-per-call MPC steps on device (the reference's
warm-start contract: tests/variable_dimensions_test.cpp:437-446).

Default solver mode is fixed-trip REAL-TIME ITERATION with the filter
line search (model-default budgets: cartpole K=5, quadrotor K=4, chain16
K=2, robust_tree K=2, others K=7; soft 3e-3 barrier restart): every
re-solve runs exactly K IPM iterations as a lax.scan, so the batch never
waits on its slowest member.  Truncated re-solves carry their warm state
to the next step; closed-loop quality is gated by `final_state_rms`
against 1.5x the measured converged-controller floor plus
`usable_frac >= 0.99` (quality_ok in the JSON).  --rti 0 restores the
convergence-tested while-loop mode; --filter-ls 0 the Armijo search.

Modes:
  mpc      (default) steady-state warm-started throughput
  cold     cold-start throughput
  latency  p50 single-solve latency (batch 1)
  scaling  weak-scaling efficiency over the first --devices devices of
           the default backend (fails when there are fewer)
  joint-theta  coupled shared-theta solve throughput on one device
"""

import argparse
import json
import sys
import time

import numpy as np

# Published peaks by device_kind (NVIDIA H100 SXM data sheet: float32
# outside the tensor cores, which is what this float32 solve runs on at
# "highest" matmul precision; HBM3 bandwidth).  A device not listed gets
# no roofline share rather than a guessed peak.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def flops_per_newton_iteration(dims) -> float:
    """Analytic FLOP count of the linear-algebra core of ONE interior-point
    iteration of ONE scenario (condensation + Riccati factor/solve +
    multiplier recovery + KKT residual).  A deliberate LOWER bound: the
    autodiff model evaluation and line-search probes are model-dependent and
    excluded.  Counts follow the recursion in ops/lqr.py (the math box of
    SURVEY.md: F-trick Cholesky factor, gain, cost-to-go update)."""
    T = dims.num_edges
    n = float(max(dims.max_state_dim, 1))
    m = float(max(dims.max_control_dim, 1))
    cn, ce = float(dims.max_node_c_dim), float(dims.max_edge_c_dim)
    gn, ge = float(dims.max_node_g_dim), float(dims.max_edge_g_dim)
    # J^T diag(w) J condensation accumulations (ops/kkt.py::kkt_factor)
    cond = 2 * n * n * (cn + gn) + 2 * (ce + ge) * (n * n + 2 * n * m
                                                    + m * m)
    # Riccati factor per edge: chol(F) n^3/3, F^{-1} formation 2n^3,
    # WA 2n^3, WB 2n^2m, B^T WB 2nm^2, chol(G) m^3/3, K = -G^{-1}H 2m^2n,
    # V update A^T WA 2n^3 + K^T H 2n^2 m
    factor = (n ** 3 / 3 + 2 * n ** 3 + 2 * n ** 3 + 2 * n * n * m
              + 2 * n * m * m + m ** 3 / 3 + 2 * m * m * n
              + 2 * n ** 3 + 2 * n * n * m)
    # backward + forward vector passes (matvecs)
    solve = 12 * n * n + 8 * n * m
    recover = 4 * n * (cn + gn) + 4 * (n + m) * (ce + ge)
    resid = 8 * n * n + 8 * n * m + 4 * n * (cn + ce + gn + ge)
    return T * (cond + factor + solve + recover + resid)


def bytes_per_newton_iteration(dims, itemsize=4) -> float:
    """Analytic HBM traffic of ONE interior-point iteration of ONE scenario,
    assuming NO fusion credit: every stacked stage array is read (and
    written where produced) once per pass it participates in.  Per-stage
    matrices are tiny (n, m <= 16), so this workload is bound by memory
    traffic and per-kernel overheads rather than arithmetic.  Fusion can
    only reduce the real traffic below this count."""
    T = dims.num_edges
    n = float(max(dims.max_state_dim, 1))
    m = float(max(dims.max_control_dim, 1))
    cn, ce = float(dims.max_node_c_dim), float(dims.max_edge_c_dim)
    gn, ge = float(dims.max_node_g_dim), float(dims.max_edge_g_dim)
    nn, nm, mm = n * n, n * m, m * m
    # model eval (autodiff outputs): A, B, Hessian blocks, Jacobians,
    # gradients, residuals — written once, read once by condensation
    jac = (cn + gn) * n + (ce + ge) * (n + m)
    model_out = (nn + nm) + (nn + 2 * nm + mm) + jac + (n + m) + (
        cn + ce + gn + ge)
    # condensation: writes Q_mod/R_mod/M_mod, reads Jacobians + weights
    cond = (nn + mm + nm) + jac + (cn + ce + gn + ge)
    # Riccati factor: read Q,R,M,A,B,delta; write F_chol,W,G_chol,K,V
    factor = (nn + mm + nm) + (nn + nm + n) + (2 * nn + mm + nm + nn)
    # backward+forward vector passes: read K,A,B,W-ish + rhs; write x,u,y
    solve = (2 * nn + nm) + 3 * n + m + (2 * n + m)
    # multiplier recovery + KKT residual oracle: re-read Jacobians
    rec = 2 * jac + (cn + ce + gn + ge)
    # line search: ~2 merit probes re-evaluating f,c,g (reads iterate+dirs)
    ls = 2 * (2 * (n + m) + cn + ce + gn + ge)
    return itemsize * T * (model_out + cond + factor + solve + rec + ls)


def get_model(name: str, horizon: int):
    from sip_optimal_control_tpu.models import (cartpole_swingup,
                                                planar_quadrotor,
                                                robust_scenario_tree,
                                                synthetic_chain)
    if name == "cartpole":
        return cartpole_swingup(horizon=horizon)
    if name == "quadrotor":
        return planar_quadrotor(horizon=horizon)
    if name == "chain16":
        return synthetic_chain(horizon=horizon, state_dim=16, control_dim=4)
    if name == "robust_tree":
        # scenario-tree robust MPC (BASELINE config 5's problem class);
        # total edges ~ horizon: 2 shared + 4 branches x (horizon-2)/4
        return robust_scenario_tree(t_shared=2, n_branches=4,
                                    t_branch=max(1, (horizon - 2) // 4))
    raise ValueError(f"unknown model {name!r}")


def build_mpc_scan(spec, dims, topo, lower, upper, settings,
                   hessian_mode="exact", steps_per_call=1, noise=0.0,
                   batch=1):
    """One dispatch = `steps_per_call` receding-horizon steps scanned on
    device (amortizes the fixed per-dispatch cost).  Returns stacked
    per-step (statuses, iterations, kkt_errors) of shape [steps, batch] so
    the timed region's quality is fully auditable."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from sip_optimal_control_tpu import build_problem, solve
    from sip_optimal_control_tpu.mpc import _shift_warm_start
    from sip_optimal_control_tpu.solver.sip import Primal

    theta0 = jnp.zeros((dims.theta_dim,), jnp.float32)
    N = dims.num_nodes

    def one(x0, warm_vars, warm_y):
        problem = build_problem(spec, dims, topo, initial_state=x0,
                                lower=lower, upper=upper,
                                hessian_mode=hessian_mode)
        res = solve(problem, settings, init_vars=warm_vars, init_y=warm_y)
        # Divergence failsafe (production-MPC standard): SOLVED iterates,
        # and MAX_ITERATIONS iterates that are still in a sane neighborhood
        # (KKT error bounded), are usable (real-time-iteration contract).
        # STALLED / DIVERGED / FACTORIZATION_FAILURE / non-finite scenarios
        # apply zero control and restart next step from the constant
        # trajectory at the new plant state, instead of carrying a
        # pathological warm state forever.
        usable = ((res.status == 0)
                  | ((res.status == 1) & (res.kkt_error < 1e2))) \
            & jnp.isfinite(res.kkt_error) \
            & jnp.all(jnp.isfinite(res.vars.x)) \
            & jnp.all(jnp.isfinite(res.vars.u))
        u0 = jnp.where(usable, res.vars.u[0], jnp.zeros_like(res.vars.u[0]))
        x_next = spec.dynamics(x0, u0, theta0, 0)
        sh_vars, sh_y = _shift_warm_start(res.vars, res.y, topo)
        reset_vars = Primal(x=jnp.tile(x_next[None], (N, 1)),
                            u=jnp.zeros_like(sh_vars.u),
                            theta=sh_vars.theta * 0)
        next_vars = jax.tree.map(
            lambda a, b: jnp.where(usable, a, b), sh_vars, reset_vars)
        next_y = jax.tree.map(
            lambda a: jnp.where(usable, a, jnp.zeros_like(a)), sh_y)
        return (x_next, next_vars, next_y, res.status, res.iterations,
                res.kkt_error)

    if steps_per_call == 1:
        # direct vmap (accepts None warm state for cold starts); per-step
        # stats have shape [batch]
        return jax.jit(jax.vmap(one))

    # Fixed-seed plant disturbance: keeps the fleet off the equilibrium
    # where shifted warm starts make re-solves trivial, while the workload
    # stays deterministic and repeatable.
    n = dims.max_state_dim
    if noise > 0.0:
        rng = np.random.default_rng(12345)
        dist = jnp.asarray(noise * rng.standard_normal(
            (steps_per_call, batch, n)).astype(np.float32))
    else:
        dist = jnp.zeros((steps_per_call, 1, n), jnp.float32)

    def many(x0, warm_vars, warm_y):
        def body(carry, dstep):
            x, wv, wy = carry
            out = jax.vmap(one)(x, wv, wy)
            return (out[0] + dstep, out[1], out[2]), out[3:]

        (x, wv, wy), (statuses, iters, kkts) = lax.scan(
            body, (x0, warm_vars, warm_y), dist)
        return x, wv, wy, statuses, iters, kkts

    return jax.jit(many)


def run_scaling(args):
    """Multi-device scaling efficiency (BASELINE tracks >=80% at >=2
    hosts).  Weak scaling: fixed batch per device, mesh sizes 1 and N,
    efficiency = thr_N / (N * thr_1), on the default backend's devices."""
    import jax
    import jax.numpy as jnp
    from sip_optimal_control_tpu import Settings
    from sip_optimal_control_tpu.parallel import (scenario_mesh,
                                                  shard_scenarios,
                                                  solve_batch_sharded)

    spec, dims, topo, lower, upper, x0 = get_model(args.model, args.horizon)
    settings = Settings(max_iterations=args.cold_iters, tol=args.tol,
                        mu_min=1e-5, reg_floor=1e-5, prox_reg=1e-5)
    devices = jax.devices()[:args.devices]
    if len(devices) < args.devices:
        sys.exit(f"--mode scaling needs {args.devices} devices, found "
                 f"{len(devices)}")
    bpd = args.batch  # batch per device (weak scaling)
    rng = np.random.default_rng(0)

    def throughput(k):
        mesh = scenario_mesh(devices[:k])
        B = bpd * k
        x0s = np.tile(np.asarray(x0, np.float32), (B, 1))
        x0s += 0.05 * rng.standard_normal(x0s.shape).astype(np.float32)
        x0s = shard_scenarios(jnp.asarray(x0s), mesh)
        fn = jax.jit(lambda b: solve_batch_sharded(
            spec, dims, topo, b, settings=settings, mesh=mesh,
            lower=lower, upper=upper))
        out = jax.block_until_ready(fn(x0s))  # compile + warm
        times = []
        for _ in range(args.reps):
            t0 = time.time()
            out = jax.block_until_ready(fn(x0s))
            times.append(time.time() - t0)
        _, statuses, stats = out
        return B / min(times), int(stats.total_solved), B

    thr_1, solved_1, b_1 = throughput(1)
    thr_n, solved_n, b_n = throughput(args.devices)
    eff = thr_n / (args.devices * thr_1)
    print(json.dumps({
        "metric": f"scaling_efficiency_{args.devices}dev",
        "value": round(eff, 4),
        "unit": "ratio",
        "vs_baseline": round(eff / 0.80, 4),
        "throughput_1dev": round(thr_1, 1),
        f"throughput_{args.devices}dev": round(thr_n, 1),
        "per_device_batch": bpd,
        "solved_frac_1dev": round(solved_1 / b_1, 4),
        f"solved_frac_{args.devices}dev": round(solved_n / b_n, 4),
        **device_fields(),
    }))


def run_joint_theta(args):
    """Coupled shared-theta solve throughput on one chip (SURVEY 2.10(c)).

    All `--batch` scenarios form ONE joint NLP sharing a global theta:
    scalar couplings (merit, residual norms, line search) and the theta
    Schur complement reduce across the scenario vmap axis inside every
    IPM iteration, so this measures the *coupled* solve — not data-
    parallel throughput.  The solution is checked live: theta must be
    bit-identical on every lane and every scenario SOLVED."""
    import jax
    import jax.numpy as jnp
    from sip_optimal_control_tpu import Settings
    from sip_optimal_control_tpu.models.shared_theta import \
        shared_theta_chain
    from sip_optimal_control_tpu.parallel import solve_joint_theta

    spec, dims, topo, lower, upper = shared_theta_chain(
        horizon=args.horizon)
    settings = Settings(max_iterations=args.cold_iters, tol=args.tol,
                        mu_min=1e-5, reg_floor=1e-5, prox_reg=1e-5)
    rng = np.random.default_rng(0)
    S = args.batch
    x0s = jnp.asarray(
        rng.standard_normal((S, 2)).astype(np.float32))

    fn = jax.jit(lambda b: solve_joint_theta(
        spec, dims, topo, b, settings=settings, lower=lower, upper=upper))
    res = jax.block_until_ready(fn(x0s))
    times = []
    for _ in range(5):
        t0 = time.time()
        res = jax.block_until_ready(fn(x0s))
        times.append(time.time() - t0)
    th = np.asarray(res.vars.theta)
    statuses = np.asarray(res.status)
    t_best = min(times)
    print(json.dumps({
        "metric": "joint_theta_coupled_scenarios_per_sec_per_chip",
        "value": round(S / t_best, 1),
        "unit": "scenarios/s/chip",
        "vs_baseline": round(S / t_best / 10000.0, 4),
        "scenarios": S,
        "horizon": args.horizon,
        "t_joint_solve_ms": round(t_best * 1e3, 2),
        "solved_frac": round(float(np.mean(statuses == 0)), 4),
        "iterations": int(np.max(np.asarray(res.iterations))),
        "theta": float(th[0, 0]),
        "theta_replicated_exactly": bool(np.all(th == th[0])),
        **device_fields(),
    }))


def device_fields():
    """The device every record names (a CPU run is never a device number)."""
    import jax
    dev = jax.devices()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices())}


def parse_args(argv=None):
    """Bench flags, with the model- and mode-dependent defaults filled
    in."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=4096)
    parser.add_argument("--horizon", type=int, default=50)
    parser.add_argument("--model",
                        choices=["cartpole", "quadrotor", "chain16",
                                 "robust_tree"],
                        default="cartpole",
                        help="robust_tree (scenario-tree robust MPC) runs "
                        "all modes; its warm start is the tree shift "
                        "(first-child successor map, mpc._shift_warm_"
                        "start_tree)")
    parser.add_argument("--mode",
                        choices=["mpc", "cold", "latency", "scaling",
                                 "joint-theta"],
                        default="mpc")
    parser.add_argument("--warm-iters", type=int, default=16)
    parser.add_argument("--warm-mu", type=float, default=None,
                        help="barrier restart for warm-started re-solves "
                        "(default: 3e-3 in RTI mode, 1e-4 in while-loop "
                        "mode — the soft restart is what lets a fixed "
                        "iteration budget recenter disturbed scenarios)")
    parser.add_argument("--cold-iters", type=int, default=100)
    parser.add_argument("--warmup-steps", type=int, default=100,
                        help="untimed MPC steps before the timed region "
                        "(long enough to clear the swing-up transient, so "
                        "the timed region measures steady-state regulation "
                        "under disturbance)")
    parser.add_argument("--steps-per-call", type=int, default=25,
                        help="MPC steps scanned inside one dispatch (mpc "
                        "mode): amortizes fixed per-dispatch cost")
    parser.add_argument("--noise", type=float, default=0.05,
                        help="plant disturbance std (fixed seed; DEFAULT "
                        "ON). Scenarios that exhaust the warm iteration "
                        "budget truncate with MAX_ITERATIONS and re-enter "
                        "warm next step, so stragglers cannot stall the "
                        "batch; their fraction is 1 - solved_frac")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the initial fleet's scatter around the "
                        "model's initial state; the plant disturbance keeps "
                        "its own fixed seed. The final_state_rms bar holds "
                        "for seed 0, where its floor was measured")
    parser.add_argument("--tol", type=float, default=1e-3)
    parser.add_argument("--ls-steps", type=int, default=None,
                        help="line-search backtracking depth cap (the "
                        "vmapped LS while_loop runs to the batch max)")
    parser.add_argument("--backtrack", type=float, default=None,
                        help="line-search backtracking factor")
    parser.add_argument("--ls-chunk", type=int, default=None,
                        help="candidate alphas per LS while-loop trip "
                        "(vectorized probe; cuts batch-max LS trips to "
                        "ceil(depth/chunk))")
    parser.add_argument("--backend", choices=["scan", "assoc", "pallas"],
                        default="pallas",
                        help="chain-Riccati backend; 'pallas' runs the "
                        "Triton kernels where the program is lowered for "
                        "CUDA and the scan elsewhere")
    parser.add_argument("--precision",
                        choices=["highest", "float32", "default"],
                        default=None,
                        help="matmul precision inside the solve (library "
                        "default 'highest' = full float32; 'default' lets "
                        "float32 matmuls run in TF32, faster but "
                        "quality-bar-gated)")
    parser.add_argument("--hessian", choices=["exact", "gauss_newton"],
                        default="gauss_newton",
                        help="Gauss-Newton is the bench default (the "
                        "real-time-MPC standard): PSD Hessian blocks, so no "
                        "indefiniteness failures on the disturbance "
                        "workload, and no second-order autodiff through "
                        "the RK4 dynamics. The library default stays "
                        "'exact' (reference-parity semantics); SOLVED "
                        "means the same thing in both modes (the "
                        "convergence test uses the exact KKT residual)")
    parser.add_argument("--devices", type=int, default=8,
                        help="mesh size for --mode scaling")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--rti", type=int, default=None, metavar="K",
                        help="real-time-iteration mode (DEFAULT; "
                        "model-default budgets, see the docstring): warm "
                        "re-solves run EXACTLY K fixed IPM iterations "
                        "(lax.scan, no while_loop), so the batch never "
                        "waits on its slowest scenario; truncated solves "
                        "carry warm state to the next step (their "
                        "fraction is 1 - solved_frac) and closed-loop "
                        "quality is gated by the final_state_rms bar + "
                        "usable_frac instead of solved_frac. 0 = off "
                        "(convergence-tested while_loop; the --warm-iters "
                        "cap applies)")
    parser.add_argument("--factor-retries", type=int, default=None,
                        help="in-iteration factorization retries (library "
                        "default 3); 0 skips the retry while_loop wrapper "
                        "entirely — failures become rejected steps with a "
                        "reg boost, retried next IPM iteration")
    parser.add_argument("--filter-ls", type=int, default=None,
                        help="1: Waechter-Biegler filter line search "
                        "(the reference's canonical settings enable it, "
                        "tests/variable_dimensions_test.cpp:18-25); 0: "
                        "Armijo merit search. Default is MODE-DEPENDENT: "
                        "filter in fixed-trip RTI mode (better acceptance "
                        "under a truncation budget), Armijo in --rti 0 "
                        "while-loop mode (the filter's nonmonotone "
                        "acceptance under persistent disturbance lets warm "
                        "re-solves wander)")
    parser.add_argument("--freeze-ev", type=int, default=None,
                        help="0: exclude the carried ModelEval from the "
                        "RTI freeze-select (Settings.rti_freeze_ev). "
                        "Model default: 0 for robust_tree (the select over "
                        "its StageModelData is pure memory traffic), 1 "
                        "elsewhere")
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)

    if args.rti is None:
        # model-default RTI budgets = each model's floor under the quality
        # gates (filter LS): cartpole 5 (K=4 fails the rms bar); chain16 2
        # = its exact convergence budget; robust_tree 2 (K=1 still
        # regulates but truncates everything); quadrotor 4 — its
        # closed-loop rms is disturbance-dominated, so the budget is chosen
        # by solved_frac health rather than the saturated rms gate
        args.rti = {"robust_tree": 2, "cartpole": 5, "quadrotor": 4,
                    "chain16": 2}.get(args.model, 7)
    if args.rti <= 0 or args.mode != "mpc":
        args.rti = None         # RTI is a warm-re-solve (mpc-mode) concept
    if args.freeze_ev is None:
        args.freeze_ev = 0 if args.model == "robust_tree" else 1
    if args.filter_ls is None:
        # Armijo for the convergence-tested warm re-solve loop (mpc
        # --rti 0), the filter everywhere else
        args.filter_ls = 0 if (args.mode == "mpc"
                               and args.rti is None) else 1
    if args.warm_mu is None:
        args.warm_mu = 3e-3 if args.rti is not None else 1e-4
    return args


def make_settings(args):
    """(cold_settings, warm_settings) for the parsed bench flags."""
    import dataclasses
    from sip_optimal_control_tpu import Settings
    from sip_optimal_control_tpu.solver.settings import LineSearchSettings

    ls_kw = {"use_filter_line_search": bool(args.filter_ls)}
    if args.ls_steps is not None:
        ls_kw["max_steps"] = args.ls_steps
    if args.backtrack is not None:
        ls_kw["backtrack"] = args.backtrack
    if args.ls_chunk is not None:
        ls_kw["chunk"] = args.ls_chunk
    f32 = dict(tol=args.tol, mu_min=1e-5, reg_floor=1e-5, prox_reg=1e-5,
               riccati_backend=args.backend,
               rti_freeze_ev=bool(args.freeze_ev),
               line_search=LineSearchSettings(**ls_kw))
    if args.factor_retries is not None:
        f32["max_factor_retries"] = args.factor_retries
    if args.precision is not None:
        f32["matmul_precision"] = args.precision
    cold_settings = Settings(max_iterations=args.cold_iters, **f32)
    if args.rti is None:
        return cold_settings, Settings(max_iterations=args.warm_iters,
                                       mu_init=args.warm_mu, **f32)
    warm_only = {}
    if args.factor_retries is None:
        # RTI default: no in-iteration retries — GN + reg floor makes
        # factor failures rare, a failure still becomes a rejected step
        # with a reg boost, and the retry while_loop wrapper is skipped.
        # Warm settings only: cold starts (constant-trajectory inits, where
        # ill-conditioned factors actually occur) keep the retry loop.
        warm_only["max_factor_retries"] = 0
    # Fixed-trip RTI: K iterations for everyone, no while_loop; the LS
    # probe is one vectorized trip (chunk = depth) unless asked otherwise.
    # Depth 6 (not the library's 10) is the shallowest budget that keeps
    # usable_frac >= 0.99 on the disturbance workload; deeper budgets only
    # add probe work.
    rti_ls = {}
    if args.ls_steps is None:
        rti_ls["max_steps"] = 6
    if args.ls_chunk is None:
        rti_ls["chunk"] = args.ls_steps if args.ls_steps is not None else 6
    f32["line_search"] = dataclasses.replace(f32["line_search"], **rti_ls)
    return cold_settings, Settings(max_iterations=args.rti,
                                   fixed_iterations=True,
                                   mu_init=args.warm_mu, **f32, **warm_only)


def initial_fleet(dims, x0, batch, seed=0):
    """Fixed-seed scattered initial states and the constant-trajectory
    warm state the MPC program starts from: (x0s, warm_vars, warm_y)."""
    import jax.numpy as jnp
    from sip_optimal_control_tpu.solver.sip import Primal, YVec

    rng = np.random.default_rng(seed)
    n, m = dims.max_state_dim, dims.max_control_dim
    N, E = dims.num_nodes, dims.num_edges
    x0s = np.tile(np.asarray(x0, np.float32), (batch, 1))
    x0s += 0.1 * rng.standard_normal((batch, n)).astype(np.float32)
    x0s = jnp.asarray(x0s)
    wv = Primal(x=jnp.tile(x0s[:, None, :], (1, N, 1)),
                u=jnp.zeros((batch, E, m), jnp.float32),
                theta=jnp.zeros((batch, dims.theta_dim), jnp.float32))
    wy = YVec(dyn=jnp.zeros((batch, N, n), jnp.float32),
              nc=jnp.zeros((batch, N, dims.max_node_c_dim), jnp.float32),
              ec=jnp.zeros((batch, E, dims.max_edge_c_dim), jnp.float32))
    return x0s, wv, wy


def main():
    args = parse_args()
    import jax
    from sip_optimal_control_tpu import build_problem, solve
    from sip_optimal_control_tpu.utils import enable_compile_cache

    enable_compile_cache()
    if args.mode == "scaling":
        run_scaling(args)
        return
    if args.mode == "joint-theta":
        run_joint_theta(args)
        return

    _T0 = time.time()
    phases = {}

    def mark(name):
        phases[name] = round(time.time() - _T0, 1)
        if args.verbose:
            print(f"# [{phases[name]:7.1f}s] {name}", file=sys.stderr,
                  flush=True)

    spec, dims, topo, lower, upper, x0 = get_model(args.model, args.horizon)
    mark("t_model")
    cold_settings, warm_settings = make_settings(args)
    x0s, wv, wy = initial_fleet(dims, x0, args.batch, args.seed)

    if args.mode == "latency":
        # p50 single-solve latency (batch 1, warm-started steady state) —
        # the real-time-MPC number BASELINE also tracks
        warm_step = build_mpc_scan(spec, dims, topo, lower, upper,
                                   warm_settings, args.hessian)
        cold_step = build_mpc_scan(spec, dims, topo, lower, upper,
                                   cold_settings, args.hessian)
        state = jax.block_until_ready(cold_step(x0s[:1], None, None))[:3]
        for _ in range(args.warmup_steps):
            state = jax.block_until_ready(warm_step(*state))[:3]
        times = []
        for _ in range(max(args.reps, 21)):
            t0 = time.time()
            jax.block_until_ready(warm_step(*state))
            times.append(time.time() - t0)
        p50_ms = float(np.median(times) * 1e3)
        print(json.dumps({
            "metric": f"p50_warm_solve_latency_ms_h{args.horizon}",
            "value": round(p50_ms, 3),
            "unit": "ms",
            # budget: a 100 Hz real-time MPC loop (10 ms per solve)
            "vs_baseline": round(10.0 / max(p50_ms, 1e-9), 4),
            "best_ms": round(min(times) * 1e3, 3),
            "model": args.model,
            **device_fields(),
        }))
        return

    if args.mode == "cold":
        def cold_one(x0_i):
            problem = build_problem(spec, dims, topo, initial_state=x0_i,
                                    lower=lower, upper=upper,
                                    hessian_mode=args.hessian)
            res = solve(problem, cold_settings)
            return res.vars.u, res.status, res.iterations, res.kkt_error
        jfn = jax.jit(jax.vmap(cold_one))
        t0 = time.time()
        out = jax.block_until_ready(jfn(x0s))
        phases["compile_s"] = round(time.time() - t0, 1)
        times = []
        for _ in range(args.reps):
            t0 = time.time()
            out = jax.block_until_ready(jfn(x0s))
            times.append(time.time() - t0)
        statuses, iters, kkt = (np.asarray(out[1])[None],
                                np.asarray(out[2])[None],
                                np.asarray(out[3])[None])
        solves_per_call = args.batch
        metric = f"batched_cold_solves_per_sec_per_chip_h{args.horizon}"
    else:
        # ONE compiled program serves cold start, warmup and the timed
        # region: the cold start is the warm program itself, started from
        # constant trajectories at each scenario's x0 (full-workspace warm
        # starts carry solver state across dispatches, so the warmup
        # dispatches converge the fleet at zero extra compile).
        warm_step = build_mpc_scan(spec, dims, topo, lower, upper,
                                   warm_settings, args.hessian,
                                   steps_per_call=args.steps_per_call,
                                   noise=args.noise, batch=args.batch)
        jax.block_until_ready((x0s, wv, wy))
        mark("t_inputs_on_device")
        t0 = time.time()
        lowered = warm_step.lower(x0s, wv, wy)
        phases["trace_s"] = round(time.time() - t0, 1)
        t0 = time.time()
        warm_step = lowered.compile()
        phases["compile_s"] = round(time.time() - t0, 1)
        mark("t_compiled")
        t0 = time.time()
        out = jax.block_until_ready(warm_step(x0s, wv, wy))
        phases["first_run_s"] = round(time.time() - t0, 1)
        # advance the receding horizon (untimed) to a representative state
        # (warmup_steps counts MPC steps, not dispatches; the first
        # dispatch above already did steps_per_call of them)
        state = out[:3]
        t0 = time.time()
        for _ in range(-(-args.warmup_steps // args.steps_per_call) - 1):
            out = jax.block_until_ready(warm_step(*state))
            state = out[:3]
        phases["warmup_s"] = round(time.time() - t0, 1)

        # time the SAME warm step repeatedly (deterministic workload); each
        # rep blocks on its result, so a rep is one dispatch's wall time
        times = []
        rep_states = []
        for _ in range(args.reps):
            t0 = time.time()
            out = jax.block_until_ready(warm_step(*state))
            times.append(time.time() - t0)
            # final plant states of this rep ([batch, n]): pooled below
            # into the closed-loop quality metric so it averages over
            # reps x batch samples of the stationary distribution
            rep_states.append(np.asarray(out[0]))
        mark("t_timed_done")
        # [steps, batch] quality stats over the WHOLE timed region
        statuses, iters, kkt = (
            np.asarray(out[3]).reshape(-1, args.batch),
            np.asarray(out[4]).reshape(-1, args.batch),
            np.asarray(out[5]).reshape(-1, args.batch))
        mark("t_fetched")
        # closed-loop CONTROL quality: RMS plant state over the timed
        # region (the real-time-iteration question is whether truncated
        # re-solves still regulate, not whether each one reached tol)
        final_state_rms = float(np.sqrt(np.mean(
            np.concatenate(rep_states, axis=0) ** 2)))
        solves_per_call = args.batch * args.steps_per_call
        metric = f"batched_mpc_solves_per_sec_per_chip_h{args.horizon}"

    t_med = float(np.median(times))
    solves_per_sec = solves_per_call / t_med
    solved_frac = float(np.mean(statuses == 0))
    diverged_frac = float(np.mean(statuses >= 2))
    mean_iters = float(np.mean(iters))
    finite_kkt = kkt[np.isfinite(kkt)]
    max_kkt = float(np.max(finite_kkt)) if finite_kkt.size else -1.0
    p50_kkt = float(np.percentile(finite_kkt, 50)) if finite_kkt.size \
        else -1.0
    p99_kkt = float(np.percentile(finite_kkt, 99)) if finite_kkt.size \
        else -1.0

    # Utilization: the vmapped while_loop executes each scan step to the
    # batch's slowest scenario, so hardware trips = sum over steps of the
    # per-step batch max; useful trips = every scenario's own count.  In
    # RTI mode the trip count is the fixed budget K instead.
    fpi = flops_per_newton_iteration(dims)
    bpi = bytes_per_newton_iteration(dims)
    if args.rti is not None:
        hw_iters = float(args.rti * statuses.shape[0]) * args.batch
    else:
        hw_iters = float(np.sum(np.max(iters, axis=1))) * args.batch
    useful_iters = float(np.sum(iters))

    # ----- quality bars ---------------------------------------------------
    # `usable` mirrors the failsafe inside the MPC step: SOLVED, or
    # truncated (MAX_ITERATIONS) but still in a sane KKT neighborhood.
    usable_frac = float(np.mean(
        (statuses == 0) | ((statuses == 1) & (kkt < 1e2))))
    quality = {"usable_frac": round(usable_frac, 4)}
    quality_ok = usable_frac >= 0.99
    if args.mode == "mpc":
        # Closed-loop bar: the fully-converged controller (--rti 0
        # --warm-iters 30) on this noise and fleet seed regulates to
        # final_state_rms ~= RMS_FLOOR; an RTI/truncated config must stay
        # within RMS_MARGIN x that floor to count as "regulating".  Floors
        # measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit.
        # The rms is dominated by a few lanes far from equilibrium, so it
        # moves with the fleet seed: on the H100, cartpole's regulating RTI
        # configurations read 1.09-1.42x the same seed's floor over seeds
        # 0-2, and the margin sits above that spread (PERF.md).
        RMS_FLOOR = {"cartpole": 0.852, "quadrotor": 0.359,
                     "chain16": 0.0734, "robust_tree": 0.152}.get(
                         args.model)
        RMS_MARGIN = 1.5
        if RMS_FLOOR is not None and args.noise == 0.05 and args.seed == 0:
            bar = RMS_MARGIN * RMS_FLOOR
            quality["final_state_rms_bar"] = round(bar, 3)
            quality_ok &= final_state_rms <= bar

    record = {
        "metric": metric,
        "value": round(solves_per_sec, 1),
        "unit": "solves/s/chip",
        "vs_baseline": round(solves_per_sec / 10000.0, 4),
        # auditable quality stats over the timed region
        "solved_frac": round(solved_frac, 4),
        "diverged_frac": round(diverged_frac, 5),
        "mean_iterations": round(mean_iters, 2),
        "max_kkt_error": float(f"{max_kkt:.3e}"),
        "p50_kkt_error": float(f"{p50_kkt:.3e}"),
        "p99_kkt_error": float(f"{p99_kkt:.3e}"),
        **quality,
        "quality_ok": bool(quality_ok),
        **({"rti_iters": args.rti} if args.rti is not None else {}),
        "tol": args.tol,
        "noise": args.noise,
        "seed": args.seed,
        "batch": args.batch,
        "model": args.model,
        "backend": args.backend,
        "hessian": args.hessian,
        "p50_batch_ms": round(t_med * 1e3, 2),
        **({"final_state_rms": round(final_state_rms, 4)}
           if args.mode == "mpc" else {}),
        # analytic linear-algebra-core FLOPs (lower bound; model autodiff
        # and line-search probes excluded) and no-fusion-credit bytes
        "flops_per_iteration": float(f"{fpi:.4g}"),
        "bytes_per_iteration": float(f"{bpi:.4g}"),
        "achieved_tflops": round(hw_iters * fpi / t_med / 1e12, 4),
        "achieved_hbm_gbps": round(hw_iters * bpi / t_med / 1e9, 1),
        # fraction of executed while_loop trips doing useful work (the
        # vmapped loop runs every scenario to the batch's slowest)
        "batch_efficiency": round(useful_iters / max(hw_iters, 1.0), 4),
        **device_fields(),
        **phases,
        "total_wall_s": round(time.time() - _T0, 1),
        "timed_reps": len(times),
    }
    peaks = PEAKS.get(record["device_kind"])
    if peaks is not None:
        record["pct_peak_f32"] = round(
            100.0 * hw_iters * fpi / t_med / peaks["f32_flops"], 3)
        record["pct_peak_hbm"] = round(
            100.0 * hw_iters * bpi / t_med / peaks["hbm_bytes"], 2)
    if args.verbose:
        print(f"# device={record['device_kind']} phases={phases} "
              f"median_batch_time={t_med * 1e3:.2f}ms", file=sys.stderr)
    print(json.dumps(record))


if __name__ == "__main__":
    main()

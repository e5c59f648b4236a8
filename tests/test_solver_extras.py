"""Solver coverage beyond chains: global theta variables (Schur path) and
scenario-tree topologies (robust MPC), both through the autodiff front door.
"""

import numpy as np
import jax
import jax.numpy as jnp

from sip_optimal_control_tpu import (Dimensions, ModelSpec, Settings,
                                     SIPStatus, Topology, build_problem,
                                     solve)


def test_theta_estimated_jointly():
    """Double integrator with unknown constant disturbance theta entering
    the dynamics; theta also carries a small prior cost.  The solver must
    recover a consistent (trajectory, theta) pair via the Schur path
    (reference theta machinery: helpers.cpp:190-240, 372-407)."""
    T, dt = 8, 0.1
    A = jnp.asarray([[1.0, dt], [0.0, 1.0]])
    B = jnp.asarray([[0.5 * dt * dt], [dt]])
    target = jnp.asarray([1.0, 0.0])

    spec = ModelSpec(
        dynamics=lambda x, u, th, i: A @ x + B @ u + dt * th,
        node_cost=lambda x, th, i: 0.5 * jnp.where(i == T, 10.0, 1.0)
        * jnp.sum((x - target) ** 2),
        edge_cost=lambda x, u, th, i: 0.5 * 0.1 * jnp.sum(u ** 2),
    )
    # theta prior: pulled toward 0.3 via a node cost on theta at the root
    spec = ModelSpec(
        dynamics=spec.dynamics,
        node_cost=lambda x, th, i: (
            0.5 * jnp.where(i == T, 10.0, 1.0) * jnp.sum((x - target) ** 2)
            + jnp.where(i == 0, 0.5 * 5.0 * jnp.sum((th - 0.3) ** 2), 0.0)),
        edge_cost=spec.edge_cost,
    )
    dims = Dimensions.uniform(num_edges=T, state_dim=2, control_dim=1,
                              theta_dim=2)
    problem = build_problem(spec, dims, Topology.chain(T),
                            initial_state=jnp.zeros(2))
    res = jax.jit(lambda: solve(problem, Settings(max_iterations=60)))()
    assert int(res.status) == SIPStatus.SOLVED
    assert float(res.kkt_error) < 1e-8
    # theta settles between the prior (0.3) and what tracking prefers
    th = np.asarray(res.vars.theta)
    assert np.all(np.isfinite(th)) and np.any(np.abs(th - 0.3) > 1e-6)


def _branching_spec(T_branch, dt, gains):
    """Scenario tree: root 0 branches into len(gains) chains of length
    T_branch; branch k's dynamics use control gain gains[k]."""
    n_branches = len(gains)
    E = n_branches * T_branch
    parents, children = [], []
    edge_gain = []
    node = 1
    for k in range(n_branches):
        prev = 0
        for t in range(T_branch):
            parents.append(prev)
            children.append(node)
            edge_gain.append(gains[k])
            prev = node
            node += 1
    gains_arr = jnp.asarray(edge_gain)
    A = jnp.asarray([[1.0, dt], [0.0, 1.0]])

    def dynamics(x, u, th, i):
        B = jnp.asarray([[0.0], [dt]]) * gains_arr[i]
        return A @ x + B @ u

    spec = ModelSpec(
        dynamics=dynamics,
        node_cost=lambda x, th, i: 0.5 * jnp.sum(x ** 2),
        edge_cost=lambda x, u, th, i: 0.5 * 0.1 * jnp.sum(u ** 2),
    )
    topo = Topology.tree(0, parents, children)
    dims = Dimensions.uniform(num_edges=E, state_dim=2, control_dim=1)
    return spec, dims, topo


def test_scenario_tree_solves():
    """Robust-MPC style scenario tree through the full IPM."""
    spec, dims, topo = _branching_spec(T_branch=6, dt=0.1, gains=[1.0, 0.5])
    x0 = jnp.asarray([1.0, 0.0])
    problem = build_problem(spec, dims, topo, initial_state=x0)
    res = jax.jit(lambda: solve(problem, Settings(max_iterations=60)))()
    assert int(res.status) == SIPStatus.SOLVED
    assert float(res.kkt_error) < 1e-8
    # branches rooted at node 0 are independent: each must match its own
    # chain solve with the same initial state
    for k, gain in enumerate([1.0, 0.5]):
        cspec, cdims, ctopo = _branching_spec(T_branch=6, dt=0.1,
                                              gains=[gain])
        cres = jax.jit(lambda p: solve(p, Settings(max_iterations=60)))(
        ) if False else jax.jit(lambda: solve(
            build_problem(cspec, cdims, ctopo, initial_state=x0),
            Settings(max_iterations=60)))()
        assert int(cres.status) == SIPStatus.SOLVED
        u_branch = np.asarray(res.vars.u)[k * 6:(k + 1) * 6]
        np.testing.assert_allclose(u_branch, np.asarray(cres.vars.u),
                                   atol=1e-7)


def test_binary_scenario_tree_with_bounds():
    """Branching at an interior node (shared first stage) + input bounds."""
    dt = 0.1
    # chain of 2 from root, then branch into two chains of 3
    parents = [0, 1, 2, 2, 3, 5, 4, 7]
    children = [1, 2, 3, 4, 5, 6, 7, 8]
    E = len(parents)
    A = jnp.asarray([[1.0, dt], [0.0, 1.0]])
    B1 = jnp.asarray([[0.0], [dt]])
    drift = jnp.asarray([0.0, 0.0, 0.0, 0.0, 0.05, 0.05, -0.05, -0.05])

    def dynamics(x, u, th, i):
        return A @ x + B1 @ u + drift[i] * jnp.asarray([1.0, 0.0])

    spec = ModelSpec(
        dynamics=dynamics,
        node_cost=lambda x, th, i: 0.5 * jnp.sum(x ** 2),
        edge_cost=lambda x, u, th, i: 0.5 * 0.05 * jnp.sum(u ** 2),
    )
    topo = Topology.tree(0, parents, children)
    dims = Dimensions.uniform(num_edges=E, state_dim=2, control_dim=1)
    from sip_optimal_control_tpu import box_bounds
    lower, upper = box_bounds(dims, u_lower=-2.0, u_upper=2.0)
    problem = build_problem(spec, dims, topo,
                            initial_state=jnp.asarray([2.0, 0.0]),
                            lower=lower, upper=upper)
    res = jax.jit(lambda: solve(problem, Settings(max_iterations=80)))()
    assert int(res.status) == SIPStatus.SOLVED
    u = np.asarray(res.vars.u)
    assert np.all(np.abs(u) <= 2.0 + 1e-8)


def test_infeasible_problem_reports_diverged():
    """An unreachable terminal equality under tight input bounds makes the
    equality multipliers blow up; the solver must report DIVERGED instead
    of burning max_iterations (no analogue in the reference's visible
    interface — sip::Status is only observed as SOLVED there)."""
    from sip_optimal_control_tpu import box_bounds
    T, dt = 5, 0.1

    spec = ModelSpec(
        dynamics=lambda x, u, th, i: jnp.stack(
            [x[0] + dt * x[1], x[1] + dt * u[0]]),
        node_cost=lambda x, th, i: 0.5 * jnp.sum(x ** 2),
        edge_cost=lambda x, u, th, i: 0.05 * jnp.sum(u ** 2),
        node_eq=lambda x, th, i: jnp.where(i == T, x[0] - 0.1, 0.0)[None],
    )
    dims = Dimensions.uniform(num_edges=T, state_dim=2, control_dim=1,
                              node_c_dim=1)
    lower, upper = box_bounds(dims, u_lower=-3.0, u_upper=3.0)
    problem = build_problem(spec, dims, Topology.chain(T),
                            initial_state=jnp.asarray([1.0, 0.0]),
                            lower=lower, upper=upper)
    res = jax.jit(lambda: solve(problem, Settings(
        max_iterations=200, diverged_kkt=1e4)))()
    assert int(res.status) == SIPStatus.DIVERGED
    assert int(res.iterations) < 200


def test_logging_flags_smoke(capfd):
    """All four logging channels print without breaking tracing
    (reference flags: variable_dimensions_test.cpp:429-432)."""
    from sip_optimal_control_tpu.solver.settings import LoggingSettings
    T = 3
    spec = ModelSpec(
        dynamics=lambda x, u, th, i: jnp.stack(
            [x[0] + 0.1 * x[1], x[1] + 0.1 * u[0]]),
        node_cost=lambda x, th, i: 0.5 * jnp.sum(x ** 2),
        edge_cost=lambda x, u, th, i: 0.05 * jnp.sum(u ** 2),
    )
    dims = Dimensions.uniform(num_edges=T, state_dim=2, control_dim=1)
    problem = build_problem(spec, dims, Topology.chain(T),
                            initial_state=jnp.asarray([1.0, 0.0]))
    res = jax.jit(lambda: solve(problem, Settings(
        max_iterations=10,
        logging=LoggingSettings(print_logs=True, print_line_search_logs=True,
                                print_search_direction_logs=True))))()
    jax.block_until_ready(res.vars.x)
    assert int(res.status) == SIPStatus.SOLVED
    out, _ = capfd.readouterr()
    assert "E0=" in out and "dir:" in out and "ls:" in out


def test_gauss_newton_hessian_mode():
    """hessian_mode='gauss_newton' (objective curvature only — the
    real-time-MPC choice; the reference's callback contract lets users fill
    any Hessian approximation, types.hpp:48-126) reaches the same optimum
    as the exact Lagrangian Hessian on a smooth problem."""
    T = 8
    spec = ModelSpec(
        dynamics=lambda x, u, th, i: jnp.stack(
            [x[0] + 0.1 * x[1], x[1] + 0.1 * jnp.sin(u[0])]),
        node_cost=lambda x, th, i: 0.5 * jnp.sum(x ** 2),
        edge_cost=lambda x, u, th, i: 0.05 * jnp.sum(u ** 2),
    )
    dims = Dimensions.uniform(num_edges=T, state_dim=2, control_dim=1)
    x0 = jnp.asarray([0.8, 0.0])
    p_ex = build_problem(spec, dims, Topology.chain(T), initial_state=x0,
                         hessian_mode="exact")
    p_gn = build_problem(spec, dims, Topology.chain(T), initial_state=x0,
                         hessian_mode="gauss_newton")
    r_ex = jax.jit(lambda: solve(p_ex, Settings(max_iterations=80)))()
    r_gn = jax.jit(lambda: solve(p_gn, Settings(max_iterations=80)))()
    assert int(r_ex.status) == SIPStatus.SOLVED
    assert int(r_gn.status) == SIPStatus.SOLVED
    np.testing.assert_allclose(np.asarray(r_gn.vars.u),
                               np.asarray(r_ex.vars.u), atol=1e-6)


def test_derivative_check_channel_prints(capfd):
    """settings.logging.print_derivative_check_logs runs the in-solver
    finite-difference derivative check at the initial iterate and prints
    the four error channels (the reference's SIP core has the same flag,
    reference: tests/variable_dimensions_test.cpp:432).  Errors must be at
    FD-truncation level for an autodiff model."""
    import re
    from sip_optimal_control_tpu.solver.settings import LoggingSettings
    T = 4
    spec = ModelSpec(
        dynamics=lambda x, u, th, i: jnp.stack(
            [x[0] + 0.1 * x[1], x[1] + 0.1 * jnp.sin(u[0])]),
        node_cost=lambda x, th, i: 0.5 * jnp.sum(x ** 2),
        edge_cost=lambda x, u, th, i: 0.05 * jnp.sum(u ** 2),
        node_ineq=lambda x, th, i: (x[0] - 5.0)[None],
    )
    dims = Dimensions.uniform(num_edges=T, state_dim=2, control_dim=1,
                              node_g_dim=1)
    problem = build_problem(spec, dims, Topology.chain(T),
                            initial_state=jnp.asarray([1.0, 0.0]))
    res = jax.jit(lambda: solve(problem, Settings(
        max_iterations=20,
        logging=LoggingSettings(print_derivative_check_logs=True))))()
    jax.block_until_ready(res.vars.x)
    out, _ = capfd.readouterr()
    assert "derivative check" in out
    m = re.search(r"gradient=([\d.e+-]+) jacobian_c=([\d.e+-]+) "
                  r"jacobian_g=([\d.e+-]+) hessian=([\d.e+-]+)", out)
    assert m is not None, out
    errs = [float(g) for g in m.groups()]
    # fp64 central differences: truncation ~eps^(2/3) ~ 4e-11 of the
    # problem scale; allow generous headroom
    assert all(e < 1e-6 for e in errs), errs


def test_nonconvex_saddle_needs_rejection_safeguard():
    """A double-well cost seeded exactly at its concave saddle: the exact
    Lagrangian Hessian is indefinite there, so unregularized Newton
    directions can be ascent directions.  The step-rejection + reg-boost
    safeguard must still drive both line-search modes to a minimum
    (VERDICT r1 item 9: a defined outcome for exhausted line searches
    instead of applying an arbitrarily tiny alpha)."""
    from sip_optimal_control_tpu.solver.settings import LineSearchSettings
    T = 12

    spec = ModelSpec(
        # mildly nonlinear dynamics so the exact Hessian carries dynamics
        # curvature through the multipliers
        dynamics=lambda x, u, th, i: jnp.stack(
            [x[0] + 0.2 * x[1] + 0.05 * jnp.sin(x[0]),
             x[1] + 0.2 * u[0]]),
        # double well in x[0] with minima at +-1; concave at x[0]=0
        node_cost=lambda x, th, i: (0.25 * (x[0] ** 2 - 1.0) ** 2
                                    + 0.5 * x[1] ** 2),
        edge_cost=lambda x, u, th, i: 0.05 * jnp.sum(u ** 2),
    )
    dims = Dimensions.uniform(num_edges=T, state_dim=2, control_dim=1)
    # seed just off the saddle (exactly at it, the saddle is a legitimate
    # stationary point by symmetry): the initial Hessian is still
    # indefinite, but the minimizer is in a well
    problem = build_problem(spec, dims, Topology.chain(T),
                            initial_state=jnp.asarray([0.05, 0.0]),
                            hessian_mode="exact")
    for use_filter in (False, True):
        settings = Settings(
            max_iterations=120, tol=1e-7,
            line_search=LineSearchSettings(
                use_filter_line_search=use_filter))
        res = jax.jit(lambda s=settings: solve(problem, s))()
        assert int(res.status) == SIPStatus.SOLVED, (
            use_filter, int(res.status), float(res.kkt_error))
        # the trajectory tail must settle into a well, not the saddle
        xT = float(np.asarray(res.vars.x)[-1, 0])
        assert abs(abs(xT) - 1.0) < 0.2, xT


def test_debug_check_finite_tripwire(capfd):
    """Settings.debug_check_finite (the device-side analogue of the reference's
    sanitizer build configs, reference: .bazelrc:38-59) prints a diagnostic
    when non-finite values enter the iterate."""
    from sip_optimal_control_tpu.solver.sip import Primal
    T = 3
    spec = ModelSpec(
        dynamics=lambda x, u, th, i: jnp.stack(
            [x[0] + 0.1 * x[1], x[1] + 0.1 * u[0]]),
        node_cost=lambda x, th, i: 0.5 * jnp.sum(x ** 2),
        edge_cost=lambda x, u, th, i: 0.05 * jnp.sum(u ** 2),
    )
    dims = Dimensions.uniform(num_edges=T, state_dim=2, control_dim=1)
    problem = build_problem(spec, dims, Topology.chain(T),
                            initial_state=jnp.asarray([1.0, 0.0]))
    bad_init = Primal(x=jnp.full((T + 1, 2), jnp.nan),
                      u=jnp.zeros((T, 1)), theta=jnp.zeros((0,)))
    res = jax.jit(lambda: solve(
        problem, Settings(max_iterations=5, debug_check_finite=True),
        init_vars=bad_init))()
    jax.block_until_ready(res.vars.x)
    out, _ = capfd.readouterr()
    assert "NONFINITE" in out, out
    # a clean solve stays silent
    res = jax.jit(lambda: solve(problem, Settings(
        max_iterations=30, debug_check_finite=True)))()
    jax.block_until_ready(res.vars.x)
    out, _ = capfd.readouterr()
    assert "NONFINITE" not in out
    assert int(res.status) == SIPStatus.SOLVED


def test_chunked_line_search_matches_sequential():
    """LineSearchSettings.chunk vectorizes the backtracking probes (chunk
    candidates per while-loop trip) but must select the SAME alpha as the
    classic sequential search — so the whole iterate sequence, and hence
    the solution, is identical.  Exercised on a nonlinear problem whose
    cold solve actually backtracks, in both merit and filter modes."""
    from sip_optimal_control_tpu.solver.settings import LineSearchSettings
    T = 10
    spec = ModelSpec(
        dynamics=lambda x, u, th, i: jnp.stack(
            [x[0] + 0.1 * jnp.sin(x[1]), x[1] + 0.1 * u[0]]),
        node_cost=lambda x, th, i: 0.5 * jnp.sum((x - 1.0) ** 2)
        + 0.1 * jnp.cos(3.0 * x[0]),
        edge_cost=lambda x, u, th, i: 0.05 * jnp.sum(u ** 2),
        edge_ineq=lambda x, u, th, i: jnp.stack([u[0] - 2.0, -2.0 - u[0]]),
    )
    dims = Dimensions.uniform(num_edges=T, state_dim=2, control_dim=1,
                              edge_g_dim=2)
    problem = build_problem(spec, dims, Topology.chain(T),
                            initial_state=jnp.asarray([0.8, -0.5]))
    # chunk=3 with the default max_steps=10 exercises the trial-budget
    # masking (chunk does not divide max_steps; ADVICE r2 medium);
    # backtrack=0.7 exercises bitwise-identical candidate generation for a
    # factor whose powers are not exactly representable (ADVICE r2 low) —
    # chunked candidates are built by the same iterated dtype
    # multiplication as the sequential search.
    for use_filter, backtrack in ((False, 0.5), (True, 0.5), (False, 0.7)):
        results = []
        for chunk in (1, 3, 10):
            st = Settings(max_iterations=40, line_search=LineSearchSettings(
                use_filter_line_search=use_filter, chunk=chunk,
                backtrack=backtrack))
            res = jax.jit(lambda st=st: solve(problem, st))()
            assert int(res.status) == SIPStatus.SOLVED, (use_filter, chunk)
            results.append(res)
        for other in results[1:]:
            np.testing.assert_array_equal(np.asarray(results[0].vars.u),
                                          np.asarray(other.vars.u))
            assert int(results[0].iterations) == int(other.iterations)


def test_fixed_iterations_matches_while_loop():
    """Settings.fixed_iterations runs the outer loop as a static-trip
    lax.scan (real-time-iteration mode).  Per-scenario results must be
    IDENTICAL to the while_loop path: a scenario's state freezes once its
    status leaves RUNNING, which is exactly the select-masking a vmapped
    while_loop applies to finished lanes.  Checked solved (terminates
    within budget) and truncated (budget smaller than need) cases, plus a
    batched solve."""
    T = 10
    spec = ModelSpec(
        dynamics=lambda x, u, th, i: jnp.stack(
            [x[0] + 0.1 * jnp.sin(x[1]), x[1] + 0.1 * u[0]]),
        node_cost=lambda x, th, i: 0.5 * jnp.sum((x - 1.0) ** 2),
        edge_cost=lambda x, u, th, i: 0.05 * jnp.sum(u ** 2),
        edge_ineq=lambda x, u, th, i: jnp.stack([u[0] - 2.0, -2.0 - u[0]]),
    )
    dims = Dimensions.uniform(num_edges=T, state_dim=2, control_dim=1,
                              edge_g_dim=2)

    def solve_from(x0, budget, fixed):
        problem = build_problem(spec, dims, Topology.chain(T),
                                initial_state=x0)
        return solve(problem, Settings(max_iterations=budget,
                                       fixed_iterations=fixed))

    for budget in (40, 4):  # terminates-in-budget and truncated
        x0 = jnp.asarray([0.8, -0.5])
        rw = jax.jit(lambda: solve_from(x0, budget, False))()
        rf = jax.jit(lambda: solve_from(x0, budget, True))()
        assert int(rw.status) == int(rf.status)
        assert int(rw.iterations) == int(rf.iterations)
        # the whole _IPMState (including the carried ModelEval, hence f)
        # is frozen by the RTI select — excluding ev was a measured
        # negative result (see sip.py); f must equal the while_loop's
        assert float(rw.f) == float(rf.f)
        np.testing.assert_array_equal(np.asarray(rw.vars.u),
                                      np.asarray(rf.vars.u))
    if budget == 40:
        assert int(rw.status) == SIPStatus.SOLVED

    # batched: mixed convergence speeds across lanes
    x0s = jnp.asarray([[0.8, -0.5], [0.1, 0.0], [-1.2, 0.7]])
    rw = jax.jit(jax.vmap(lambda x0: solve_from(x0, 25, False)))(x0s)
    rf = jax.jit(jax.vmap(lambda x0: solve_from(x0, 25, True)))(x0s)
    np.testing.assert_array_equal(np.asarray(rw.status),
                                  np.asarray(rf.status))
    np.testing.assert_array_equal(np.asarray(rw.iterations),
                                  np.asarray(rf.iterations))
    np.testing.assert_array_equal(np.asarray(rw.vars.u),
                                  np.asarray(rf.vars.u))
    np.testing.assert_array_equal(np.asarray(rw.kkt_error),
                                  np.asarray(rf.kkt_error))


def test_locally_infeasible_stalls_and_mpc_failsafe_contains_it():
    """Restoration-class robustness contract (VERDICT r2 item 9).

    The node equality sin(x0) = 1.2 is unsatisfiable; the iterate is drawn
    toward the infeasible stationary point x0 -> pi/2 where the constraint
    gradient vanishes.  A solver without feasibility restoration cannot
    recover from this; the DOCUMENTED behavior contract here is: the
    rejection safeguard trips (consecutive rejected steps under inflated
    regularization) and the solve exits STALLED — quickly (well under the
    iteration budget), with finite iterates, in BOTH line-search modes
    (the reference's globalization lives in the unvendored @sip core; its
    visible contract is only that unsolved statuses are reported, which
    STALLED refines).

    Second half: the MPC failsafe (mpc.run_mpc reset_on_failure) must
    CONTAIN the failure — zero control applied on failed re-solves, plant
    states stay finite, and the loop keeps running instead of poisoning
    its warm state."""
    from sip_optimal_control_tpu import box_bounds
    from sip_optimal_control_tpu.mpc import run_mpc
    from sip_optimal_control_tpu.solver.settings import LineSearchSettings

    T, dt = 5, 0.1
    spec = ModelSpec(
        dynamics=lambda x, u, th, i: jnp.stack(
            [x[0] + dt * x[1], x[1] + dt * u[0]]),
        node_cost=lambda x, th, i: 0.5 * jnp.sum(x ** 2),
        edge_cost=lambda x, u, th, i: 0.05 * jnp.sum(u ** 2),
        node_eq=lambda x, th, i: jnp.where(
            i == T, jnp.sin(x[0]) - 1.2, 0.0)[None],
    )
    dims = Dimensions.uniform(num_edges=T, state_dim=2, control_dim=1,
                              node_c_dim=1)
    lower, upper = box_bounds(dims, u_lower=-3.0, u_upper=3.0)
    problem = build_problem(spec, dims, Topology.chain(T),
                            initial_state=jnp.asarray([1.0, 0.0]),
                            lower=lower, upper=upper)
    for use_filter in (False, True):
        st = Settings(max_iterations=300, line_search=LineSearchSettings(
            use_filter_line_search=use_filter))
        res = jax.jit(lambda st=st: solve(problem, st))()
        assert int(res.status) == SIPStatus.STALLED, (
            use_filter, int(res.status))
        assert int(res.iterations) < 60        # gives up fast, no burn
        assert bool(jnp.all(jnp.isfinite(res.vars.x)))
        assert bool(jnp.all(jnp.isfinite(res.vars.u)))

    # MPC failsafe: every re-solve fails, so every applied control is the
    # zero fallback and the plant just drifts under its own (stable-ish)
    # dynamics — finite throughout, statuses all non-SOLVED.
    trace = jax.jit(lambda: run_mpc(
        spec, dims, Topology.chain(T), jnp.asarray([1.0, 0.0]),
        n_steps=5, settings=Settings(max_iterations=40),
        lower=lower, upper=upper))()
    assert bool(jnp.all(jnp.isfinite(trace.states)))
    assert bool(jnp.all(trace.statuses != SIPStatus.SOLVED))
    np.testing.assert_allclose(np.asarray(trace.controls), 0.0, atol=0.0)


def test_fixed_iterations_matches_while_loop_on_tree():
    """RTI-mode parity on a scenario-TREE topology (the chain case is
    covered above): the level-synchronous tree Riccati path must behave
    identically under the static-trip scan."""
    spec, dims, topo = _branching_spec(T_branch=4, dt=0.1, gains=[1.0, 0.6])
    x0 = jnp.asarray([1.0, 0.0])

    def run(fixed):
        problem = build_problem(spec, dims, topo, initial_state=x0)
        return solve(problem, Settings(max_iterations=30,
                                       fixed_iterations=fixed))

    rw = jax.jit(lambda: run(False))()
    rf = jax.jit(lambda: run(True))()
    assert int(rw.status) == SIPStatus.SOLVED
    assert int(rw.status) == int(rf.status)
    assert int(rw.iterations) == int(rf.iterations)
    np.testing.assert_array_equal(np.asarray(rw.vars.u),
                                  np.asarray(rf.vars.u))
    assert float(rw.kkt_error) == float(rf.kkt_error)


def test_rti_freeze_ev_exclusion_same_outputs():
    """Settings.rti_freeze_ev=False (the carried ModelEval excluded from
    the fixed-trip freeze-select) must leave every consumed output —
    iterates, duals, statuses, iteration counts, kkt_error — identical;
    only SolveResult.f on early-frozen lanes may report a post-freeze
    iterate (documented).  Batch chosen so some lanes converge early."""
    spec, dims, topo = _branching_spec(T_branch=4, dt=0.1,
                                       gains=[1.0, 0.6])
    rng = np.random.default_rng(5)
    x0s = jnp.asarray(rng.standard_normal((6, 2)))

    def run(freeze):
        def one(x0):
            problem = build_problem(spec, dims, topo, initial_state=x0)
            return solve(problem, Settings(max_iterations=30,
                                           fixed_iterations=True,
                                           rti_freeze_ev=freeze))
        return jax.jit(jax.vmap(one))(x0s)

    a = run(True)
    b = run(False)
    assert np.asarray(a.iterations).max() < 30      # some lanes froze early
    for name in ("vars", "y", "zl", "zu", "status", "iterations",
                 "kkt_error", "mu"):
        for la, lb in zip(jax.tree.leaves(getattr(a, name)),
                          jax.tree.leaves(getattr(b, name))):
            np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))


def test_level_scan_boundary_parity():
    """A tree shape near the use_level_scan threshold must produce
    identical results from the unrolled and scan tree backends (VERDICT
    r4 weak #6: a silent backend switch must never change results)."""
    from sip_optimal_control_tpu.ops.lqr import (_factor_tree,
                                                 _factor_tree_scan,
                                                 _solve_tree,
                                                 _solve_tree_scan,
                                                 use_level_scan)
    from sip_optimal_control_tpu import (LQRData, Topology,
                                         compile_topology)

    # path of 9 + a 3-wide fan at the end: L = 11, W = 3, N = 13
    parents = list(range(9)) + [9, 9, 9]
    children = list(range(1, 10)) + [10, 11, 12]
    topo = Topology.tree(0, parents, children)
    sched = compile_topology(topo)
    assert use_level_scan(sched)        # just past the L > 8 threshold
    N, E, n, m = 13, 12, 3, 2
    rng = np.random.default_rng(7)

    def spd(S, k):
        L = rng.standard_normal((S, k, k))
        return L @ np.swapaxes(L, 1, 2) + 2.0 * np.eye(k)

    data = LQRData(
        Q=jnp.asarray(spd(N, n)), q=jnp.asarray(rng.standard_normal((N, n))),
        c=jnp.asarray(rng.standard_normal((N, n))),
        delta=jnp.asarray(0.1 + rng.random((N, n))),
        A=jnp.asarray(rng.standard_normal((E, n, n))),
        B=jnp.asarray(rng.standard_normal((E, n, m))),
        M=jnp.asarray(0.3 * rng.standard_normal((E, n, m))),
        R=jnp.asarray(spd(E, m)),
        r=jnp.asarray(rng.standard_normal((E, m))))
    fa = _factor_tree(data, sched)
    fb = _factor_tree_scan(data, sched)
    sa = _solve_tree(data, fa, sched)
    sb = _solve_tree_scan(data, fb, sched)
    assert int(np.asarray(fa.status)) == int(np.asarray(fb.status)) == 0
    for la, lb in zip(jax.tree.leaves(sa), jax.tree.leaves(sb)):
        np.testing.assert_allclose(np.asarray(la), np.asarray(lb),
                                   atol=1e-11)

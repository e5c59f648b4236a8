"""Smoke test of the batched MPC fleet on one NVIDIA GPU.

Drives the main path once through the entry points a user calls
(`build_problem` + `solve` under `jax.vmap`, inside bench.py's on-device
receding-horizon scan) at the bench's full size, and checks every kernel
on that path against its plain reference:

  1. device check: JAX's devices are GPUs, and enough of them; prints the
     card's name and power limit, the JAX version and XLA_FLAGS
  2. kernel parity: the `pallas` chain-Riccati backend against the
     `lax.scan` reference at (n, m) = (4, 1), (6, 2), (16, 4), T = 50,
     batch 4096 and 4095 (Triton kernels up to n = _MAX_N, the scan by
     the shape rule above it)
  3. fleet MPC: cartpole swing-up, horizon 50, batch 4096, the bench's
     default real-time iteration; cold start, then timed dispatches
  4. CPU cross-check: the first warm re-solve of 64 lanes, once on the
     GPU and once on the CPU (the scan branch) in this process
  5. tree path: robust scenario-tree warm MPC for a few dispatches

With `--cards 4` only the four-card phase runs: sharded warm re-solves of
a converged fleet over a 1-D four-card scenario mesh against a single-card
vmap of the same batch, and the sharded joint-theta solve against its
unsharded form, both in float64; then the float32 sharded fleet on the
Triton kernels.

Any failed phase exits non-zero.  The last line of stdout is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.

Usage: python chip_smoke.py [--cards 4]
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

T = 50
BATCH = 4096
STEPS = 25


def phase(name):
    print(f"== {name}", flush=True)


def check(ok, what):
    if not ok:
        raise SystemExit(f"FAILED: {what}")
    print(f"   ok: {what}", flush=True)


def triton_calls(jitted, *args):
    """Number of Triton kernel launches in the program as lowered here."""
    return jitted.trace(*args).lower().as_text().count(
        "__gpu$xla.gpu.triton")


def device_check(cards):
    import jax
    phase("1. device check")
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"FAILED: no GPU: JAX's default backend is "
            f"{devices[0].platform}; this smoke test has no CPU fallback")
    check(len(devices) >= cards,
          f"{len(devices)} GPU(s) present, {cards} needed")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    print(f"   jax {jax.__version__}, device_kind {devices[0].device_kind!r},"
          f" XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}", flush=True)
    return devices


def kernel_parity():
    import jax
    import jax.numpy as jnp
    from benchmarks.common import random_chain_batch
    from sip_optimal_control_tpu import Topology, compile_topology
    from sip_optimal_control_tpu.ops.lqr import (lqr_factor,
                                                 lqr_residual_norm, lqr_solve)

    from sip_optimal_control_tpu.ops.pallas_riccati import _MAX_N

    phase("2. chain-Riccati kernel parity (Triton vs lax.scan)")
    sched = compile_topology(Topology.chain(T))

    def program(backend):
        def run(d):
            fact = lqr_factor(d, sched, backend)
            sol = lqr_solve(d, fact, sched, backend)
            return sol, fact.status, lqr_residual_norm(d, sol, sched)
        return jax.jit(jax.vmap(run))

    kernel, scan = program("pallas"), program("scan")
    for i, (n, m) in enumerate(((4, 1), (6, 2), (16, 4))):
        for batch in (BATCH, BATCH - 1):
            data = random_chain_batch(jax.random.key(i), T, n, m, batch)
            calls = triton_calls(kernel, data)
            path = ("Triton kernels" if n <= _MAX_N
                    else f"lax.scan (n > _MAX_N = {_MAX_N})")
            check(calls == (3 if n <= _MAX_N else 0),
                  f"n={n} m={m} B={batch}: path = {path} ({calls} Triton "
                  f"calls in the lowered program)")
            # both at "highest", as inside solve(): TF32 never enters
            with jax.default_matmul_precision("highest"):
                sol, st, res = kernel(data)
                sol_r, st_r, res_r = scan(data)
            diff = max(float(jnp.max(jnp.abs(getattr(sol, k)
                                             - getattr(sol_r, k))
                                     / (1.0 + jnp.abs(getattr(sol_r, k)))))
                       for k in ("x", "u", "y"))
            print(f"   n={n} m={m} B={batch}: max residual kernel "
                  f"{float(jnp.max(res)):.2e} scan {float(jnp.max(res_r)):.2e},"
                  f" max |diff|/(1+|ref|) {diff:.2e}", flush=True)
            check(bool(jnp.all(st == st_r)), "statuses equal")
            check(float(jnp.max(res)) <= 1e-3
                  and float(jnp.max(res_r)) <= 1e-3, "residuals <= 1e-3")
            for k in ("x", "u", "y"):
                np.testing.assert_allclose(
                    np.asarray(getattr(sol, k)), np.asarray(getattr(sol_r, k)),
                    rtol=1e-3, atol=1e-3, err_msg=f"n={n} m={m} {k}")
            check(True, "x, u, y within rtol = atol = 1e-3")


def fleet(model, dispatches, warmup):
    """Cold start plus `warmup` untimed and `dispatches` timed dispatches of
    the bench's warm MPC program; returns the solver state after the cold
    start and the timed region's statistics."""
    import jax
    import jax.numpy as jnp
    import bench

    args = bench.parse_args(["--model", model, "--backend", "pallas"])
    spec, dims, topo, lower, upper, x0 = bench.get_model(model, T)
    _, warm_settings = bench.make_settings(args)
    step = bench.build_mpc_scan(spec, dims, topo, lower, upper,
                                warm_settings, args.hessian,
                                steps_per_call=STEPS, noise=args.noise,
                                batch=BATCH)
    state = bench.initial_fleet(dims, x0, BATCH)
    print(f"   path: bench warm MPC scan, riccati_backend="
          f"{warm_settings.riccati_backend}, {triton_calls(step, *state)} "
          f"Triton calls in the program", flush=True)
    t0 = time.perf_counter()
    out = jax.block_until_ready(step(*state))
    print(f"   cold start (compile + first dispatch) "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cold_state = out[:3]
    for _ in range(warmup):
        out = jax.block_until_ready(step(*out[:3]))
    stats, t0 = [], time.perf_counter()
    for _ in range(dispatches):
        out = jax.block_until_ready(step(*out[:3]))
        stats.append([np.asarray(a) for a in out[3:]])
    secs = time.perf_counter() - t0
    statuses, iters, kkt = (np.concatenate(s) for s in zip(*stats))
    finite = all(bool(jnp.all(jnp.isfinite(a)))
                 for a in jax.tree.leaves(out[:3]))
    usable = float(np.mean((statuses == 0) | ((statuses == 1) & (kkt < 1e2))))
    ok_kkt = kkt[np.isfinite(kkt)]
    print(f"   {model}: {dispatches * STEPS * BATCH / secs:.0f} solves/s "
          f"(for information), solved_frac {np.mean(statuses == 0):.4f}, "
          f"usable_frac {usable:.4f}, p99 KKT error "
          f"{np.percentile(ok_kkt, 99):.3e}", flush=True)
    check(finite, f"{model}: plant and warm states finite")
    check(usable >= 0.99, f"{model}: usable_frac {usable:.4f} >= 0.99")
    return warm_settings, (spec, dims, topo, lower, upper), cold_state


def cpu_cross_check(warm_settings, problem_parts, cold_state, lanes=64):
    import jax
    import jax.numpy as jnp
    from sip_optimal_control_tpu import build_problem, solve

    phase("4. CPU cross-check of the first warm re-solve")
    spec, dims, topo, lower, upper = problem_parts

    def one(x0, wv, wy):
        problem = build_problem(spec, dims, topo, initial_state=x0,
                                lower=lower, upper=upper,
                                hessian_mode="gauss_newton")
        res = solve(problem, warm_settings, init_vars=wv, init_y=wy)
        return res.vars.u[0], res.status

    fn = jax.jit(jax.vmap(one))
    args = jax.tree.map(lambda a: a[:lanes], cold_state)
    u_g, st_g = fn(*args)
    cpu = jax.devices("cpu")[0]
    args_c = jax.device_put(args, cpu)
    print(f"   path: GPU program {triton_calls(fn, *args)} Triton calls, "
          f"CPU program {fn.trace(*args_c).lower(lowering_platforms=('cpu',)).as_text().count('triton')} "
          f"(scan branch)", flush=True)
    u_c, st_c = fn(*args_c)
    st_g, st_c = np.asarray(st_g), np.asarray(st_c)
    both = (st_g == 0) & (st_c == 0)
    du = float(np.max(np.abs(np.asarray(u_g) - np.asarray(u_c))[both],
                      initial=0.0))
    mismatched = int(np.sum(st_g != st_c))
    print(f"   {int(both.sum())}/{lanes} lanes SOLVED on both, max |du0| "
          f"{du:.2e}, statuses differ on {mismatched}", flush=True)
    check(both.any(), "some lanes SOLVED on both devices")
    check(du <= 1e-3, "first control within 1e-3 on lanes SOLVED on both")
    check(mismatched <= 2, f"{mismatched} <= 2 of {lanes} statuses differ")


def four_cards(devices, batch=BATCH):
    """Sharded warm re-solves of a converged cartpole fleet against the
    same re-solves vmapped on one card, then the sharded joint-theta solve
    against its unsharded form.

    The comparisons run in float64.  A re-solve to tol 1e-3 amplifies
    rounding about 1e4-fold on ill-conditioned lanes, so two programs that
    round differently (1024 vs 4096 lanes per program) disagree beyond
    1e-3 in float32 even with equal iteration counts: on four CPU devices
    at B = 256, up to 7.8e-3 in float32 and 3.5e-12 in float64.  The
    float32 sharded fleet, which runs the Triton kernels, is then checked
    on its own."""
    import jax
    import jax.numpy as jnp
    import bench
    from sip_optimal_control_tpu import Settings, build_problem, solve
    from sip_optimal_control_tpu.models import cartpole_swingup
    from sip_optimal_control_tpu.models.shared_theta import \
        shared_theta_chain
    from sip_optimal_control_tpu.parallel import (scenario_mesh,
                                                  shard_scenarios,
                                                  solve_batch_sharded,
                                                  solve_joint_theta)

    phase("6. four cards: sharded fleet and joint theta")
    mesh = scenario_mesh(devices[:4])
    settings = Settings(max_iterations=100, tol=1e-3, mu_min=1e-5,
                        reg_floor=1e-5, prox_reg=1e-5,
                        riccati_backend="pallas")
    spec, dims, topo, lower, upper, x0 = cartpole_swingup(horizon=T)

    def one(x, wv, wy):
        problem = build_problem(spec, dims, topo, initial_state=x,
                                lower=lower, upper=upper)
        res = solve(problem, settings, init_vars=wv, init_y=wy)
        return res.vars, res.y, res.status

    sharded = jax.jit(lambda x, v, y: solve_batch_sharded(
        spec, dims, topo, x, settings=settings, mesh=mesh, lower=lower,
        upper=upper, init_vars=v, init_y=y))
    rng = np.random.default_rng(1)
    with jax.enable_x64(True):
        # one program serves the cold start (from bench's constant
        # trajectories) and the single-card warm reference
        single = jax.jit(jax.vmap(one))
        fleet = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                             bench.initial_fleet(dims, x0, batch))
        x0s, wv, wy = jax.device_put(fleet, devices[0])
        vars_c, y_c, st_c = single(x0s, wv, wy)
        solved = np.flatnonzero(np.asarray(st_c) == 0)
        check(solved.size >= batch // 2,
              f"float64 cold start on one card: {solved.size}/{batch} "
              f"lanes SOLVED")
        # the converged fleet, perturbed as by a state-estimate update
        idx = jnp.asarray(np.resize(solved, batch))
        warm = jax.tree.map(lambda a: a[idx], (vars_c, y_c))
        x0w = x0s[idx] + 0.01 * jnp.asarray(rng.standard_normal(x0s.shape))
        vars_1, _, st_1 = single(x0w, *warm)
        u_s, st_s, _ = sharded(*shard_scenarios((x0w, *warm), mesh))
        st_s, st_1 = np.asarray(st_s), np.asarray(st_1)
        u_1 = np.asarray(vars_1.u)
        du = float(np.max(np.abs(np.asarray(u_s) - u_1)))
        print(f"   float64 warm re-solve of B={batch} over "
              f"{mesh.devices.size} cards: solved {int(np.sum(st_s == 0))} "
              f"(one card {int(np.sum(st_1 == 0))}), statuses differ on "
              f"{int(np.sum(st_s != st_1))}, max |du| {du:.2e}", flush=True)
        check(bool(np.all(st_s == st_1)), "sharded statuses == single-card")
        check(du <= 1e-3, "sharded controls within 1e-3 of single-card")

        jspec, jdims, jtopo, jlower, jupper = shared_theta_chain(horizon=T)
        # positions around 1, so that the shared setpoint is far from 0
        xs = jnp.asarray(rng.standard_normal((batch, 2)) + [1.0, 0.0])
        res_s = jax.jit(lambda b: solve_joint_theta(
            jspec, jdims, jtopo, b, settings=settings, mesh=mesh,
            lower=jlower, upper=jupper))(shard_scenarios(xs, mesh))
        res_1 = jax.jit(lambda b: solve_joint_theta(
            jspec, jdims, jtopo, b, settings=settings, lower=jlower,
            upper=jupper))(jax.device_put(xs, devices[0]))
        th_s = np.asarray(res_s.vars.theta)
        th_1 = np.asarray(res_1.vars.theta)
        rel = float(np.max(np.abs(th_s - th_1) / np.abs(th_1)))
        print(f"   float64 joint theta over {batch} scenarios: theta "
              f"{th_s[0]}, max relative difference {rel:.2e}", flush=True)
        check(rel <= 1e-5, "sharded theta within 1e-5 relative of unsharded")
        check(bool(np.all(np.asarray(res_s.status) == 0)
                   & np.all(np.asarray(res_1.status) == 0)),
              "every lane SOLVED, sharded and unsharded")

    # the float32 fleet, as users run it: Triton kernels on every card
    args32 = shard_scenarios(jax.tree.map(
        lambda a: np.asarray(a, np.float32), (x0w, *warm)), mesh)
    calls = triton_calls(sharded, *args32)
    check(calls > 0, f"float32 sharded program: {calls} Triton calls")
    u_32, st_32, stats = sharded(*args32)
    st_32 = np.asarray(st_32)
    print(f"   float32 warm re-solve over {mesh.devices.size} cards: solved "
          f"{int(np.sum(st_32 == 0))}/{batch}, max KKT error "
          f"{float(stats.max_kkt_error):.2e}, max |du| against float64 "
          f"{float(np.max(np.abs(np.asarray(u_32) - u_1))):.2e} (for "
          f"information)", flush=True)
    check(bool(np.all(np.isfinite(np.asarray(u_32)))),
          "float32 sharded controls finite")
    check(float(np.mean(st_32 == 0)) >= 0.99,
          "float32 sharded: >= 0.99 of lanes SOLVED")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-card phase")
    cards = ap.parse_args().cards

    import jax
    devices = device_check(cards)

    from sip_optimal_control_tpu.utils import enable_compile_cache
    enable_compile_cache()
    if cards == 4:
        four_cards(devices)
    else:
        kernel_parity()
        phase("3. fleet MPC, cartpole swing-up")
        warm_settings, parts, cold_state = fleet("cartpole", dispatches=3,
                                                 warmup=3)
        cpu_cross_check(warm_settings, parts, cold_state)
        phase("5. tree path, robust scenario-tree MPC")
        fleet("robust_tree", dispatches=2, warmup=3)
    dev = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    sys.exit(main())

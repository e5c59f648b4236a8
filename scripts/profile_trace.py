"""Device trace of one warm bench dispatch on the GPU: where the time goes.

Builds bench.py's warm MPC program from the same flags bench.py takes,
runs the cold start and the warmup untimed, then traces ONE dispatch with
`jax.profiler` and reduces the trace to:

  - the dispatch's host wall window, the device's busy time in it (the
    union of kernel intervals on the GPU) and its idle share;
  - device time by category, read from each kernel's HLO op and the named
    scopes the solver sets: riccati (the chain kernels, or the scan),
    line_search (the probe), model_eval (autodiff of the model),
    newton_step (condensation, multiplier recovery), other;
  - the top kernels by device time.

Prints the top kernels, then one JSON object as the last line.  The raw
trace and the program's HLO text stay in --outdir (default: a new
directory under $TMPDIR, printed on stderr).  Needs a GPU.

Usage: python scripts/profile_trace.py [bench flags] [--outdir DIR]
    [--top 25]
"""

import collections
import glob
import json
import os
import re
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# (category, marker in the kernel name or its HLO op_name).  The first match
# wins: a fusion whose joined op_names hold several scopes counts under the
# first of them in this order.
CATEGORIES = (("riccati", "riccati"), ("line_search", "line_search"),
              ("model_eval", "model_eval"), ("newton_step", "newton_step"))
WINDOW = "profiled_dispatch"


def hlo_scopes(hlo_text):
    """HLO instruction name -> the metadata op_name (the named-scope path
    of the JAX operation it came from).  A multi-output fusion carries no
    metadata of its own; it gets the op_names of every instruction of the
    computation it calls, joined.  Each name is also keyed as the GPU
    kernel XLA emits for it is named, with '.' and '-' as '_'
    (loop_select_fusion.4 -> loop_select_fusion_4)."""
    inst = re.compile(r'^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=')
    op = re.compile(r'op_name="([^"]*)"')
    calls = re.compile(r'calls=%([\w.\-]+)')
    scopes, called, by_comp, comp = {}, {}, {}, None
    for line in hlo_text.splitlines():
        if line and not line[0].isspace():
            head = re.match(r'(?:ENTRY\s+)?%([\w.\-]+)', line)
            comp = head.group(1) if head else None
            continue
        m = inst.match(line)
        if not m:
            continue
        o, c = op.search(line), calls.search(line)
        if o:
            scopes[m.group(1)] = o.group(1)
            by_comp.setdefault(comp, []).append(o.group(1))
        elif c:
            called[m.group(1)] = c.group(1)
    for name, c in called.items():
        scopes[name] = "|".join(by_comp.get(c, []))
    for name, op_name in list(scopes.items()):
        scopes.setdefault(re.sub(r"[.\-]", "_", name), op_name)
    return scopes


def category(name, op_name):
    for cat, marker in CATEGORIES:
        if marker in name or marker in op_name:
            return cat
    return "other"


def union_ns(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(xspace_path, scopes, top=25):
    """Device-time breakdown of the traced window (see the module doc)."""
    import jax

    prof = jax.profiler.ProfileData.from_file(xspace_path)
    window = None
    kernels = []            # (start_ns, end_ns, name, hlo_op)
    for plane in prof.planes:
        gpu = plane.name.startswith("/device:GPU:")
        for line in plane.lines:
            for ev in line.events:
                if not gpu:
                    if ev.name == WINDOW:
                        window = (ev.start_ns, ev.start_ns + ev.duration_ns)
                    continue
                if not line.name.startswith("Stream"):
                    continue
                kernels.append((ev.start_ns, ev.start_ns + ev.duration_ns,
                                ev.name, str(dict(ev.stats).get("hlo_op"))))
    if window is None or not kernels:
        raise SystemExit("trace holds no dispatch window or no GPU kernels")
    inside = [k for k in kernels if k[1] > window[0] and k[0] < window[1]]
    busy = union_ns([(max(s, window[0]), min(e, window[1]))
                     for s, e, _, _ in inside])
    by_cat, by_kernel, count = (collections.Counter(), collections.Counter(),
                                collections.Counter())
    for s, e, name, hlo_op in inside:
        # kernels launched from a command buffer carry that buffer, not
        # the op, as hlo_op
        op_name = scopes.get(name) or scopes.get(hlo_op, "")
        by_cat[category(name, op_name)] += e - s
        by_kernel[name] += e - s
        count[name] += 1
    kernel_ns = sum(by_cat.values())
    wall = window[1] - window[0]
    return {
        "window_ms": wall / 1e6,
        "device_busy_ms": busy / 1e6,
        "idle_share": 1.0 - busy / wall,
        "kernel_launches": len(inside),
        "kernel_time_ms": kernel_ns / 1e6,
        "share_of_kernel_time": {c: by_cat[c] / kernel_ns
                                 for c, _ in CATEGORIES + (("other", ""),)},
        "top_kernels": [(n, by_kernel[n] / 1e6, count[n])
                        for n, _ in by_kernel.most_common(top)],
    }


def main():
    argv = sys.argv[1:]
    outdir, top = None, 25
    for flag in ("--outdir", "--top"):
        if flag in argv:
            i = argv.index(flag)
            val = argv[i + 1]
            del argv[i:i + 2]
            outdir, top = (val, top) if flag == "--outdir" else (outdir,
                                                                 int(val))

    import jax
    import bench
    from sip_optimal_control_tpu.utils import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        sys.exit("profile_trace.py needs a GPU")
    enable_compile_cache()
    args = bench.parse_args(argv)
    spec, dims, topo, lower, upper, x0 = bench.get_model(args.model,
                                                         args.horizon)
    _, warm_settings = bench.make_settings(args)
    step = bench.build_mpc_scan(spec, dims, topo, lower, upper,
                                warm_settings, args.hessian,
                                steps_per_call=args.steps_per_call,
                                noise=args.noise, batch=args.batch)
    state = bench.initial_fleet(dims, x0, args.batch)
    compiled = step.lower(*state).compile()
    for _ in range(-(-args.warmup_steps // args.steps_per_call)):
        state = jax.block_until_ready(compiled(*state))[:3]
    if outdir is None:
        outdir = tempfile.mkdtemp(prefix="soc_trace_")
    os.makedirs(outdir, exist_ok=True)
    print(f"# trace directory: {outdir}", file=sys.stderr)
    hlo = compiled.as_text()
    with open(os.path.join(outdir, "program.hlo.txt"), "w") as f:
        f.write(hlo)
    with jax.profiler.trace(outdir):
        with jax.profiler.TraceAnnotation(WINDOW):
            jax.block_until_ready(compiled(*state))

    path = sorted(glob.glob(os.path.join(
        outdir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    rec = reduce_trace(path, hlo_scopes(hlo), top)
    trips = args.steps_per_call * (args.rti or args.warm_iters)
    print(f"# one dispatch = {args.steps_per_call} MPC steps x "
          f"{args.rti or args.warm_iters} IPM trips = {trips} trips")
    print(f"{'total ms':>10} {'count':>7}  kernel")
    for name, ms, cnt in rec.pop("top_kernels"):
        print(f"{ms:10.3f} {cnt:7d}  {name[:90]}")
    print(json.dumps(dict(rec, model=args.model, backend=args.backend,
                          batch=args.batch, **bench.device_fields())))


if __name__ == "__main__":
    main()

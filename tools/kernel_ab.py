"""Time the TB kernels of one checkout of the port on the card, to compare
two versions in one call (run them in turns: parent, change, change,
parent):

    python3 tools/kernel_ab.py <checkout root> [--grid] [--each-schedule]
                               [--physics acoustic,tti,elastic]

Prints the registers ptxas gives each kernel instantiation, then, at the
paper's 512^3 shapes (tile 32, T = 4, order 4), the kernel alone per
physics — the median, least and most of 3 means of 5 launches after a
warm-up, by CUDA events — for one shot and, where the checkout has the
shot-batched launch, for two (acoustic and TTI), and fingerprints of the
one-shot launch's outputs (the sum and the xor of the float32 bit
patterns): of the state fields bit for bit, and of the receiver partials
with -0 read as +0 (a padding slot's partial is w * sample = 0 with either
sign).  The launch carries the paper case's off-the-grid source (its
first T steps' values, binned to every tile whose window holds one of its
points) and its 512 receivers (`chip_smoke.full_case`), so the partials
and the injection are part of the fingerprint.  Two checkouts whose
kernels compute the same function print the same fingerprints.

`--grid` times the kernels instead at space orders 4, 8 and 12 and depths
T = 1, 2 and 4 (tile 32, one shot), with the same fingerprints and the
launch plan where the checkout has one; a configuration the checkout
refuses, or that does not fit the card's memory, prints why and the sweep
goes on.  With `--each-schedule` every configuration runs once on each
schedule the checkout's kernel has there (the first, the z-streamed one
where a sub-tile fits: `stencil_tb.stream_plan`, and the cluster-shared
trapezoid where the checkout has one: `stencil_tb.cluster_plan`),
whatever `launch_plan` picks.  `--physics` names the kernels (default: all three).
Where the checkout keeps the params' copies outside the launch
(`stencil_tb.param_copies`), they are made once before the timed
launches, as a propagation makes them.  Needs a card.
"""
import contextlib
import statistics
import sys

import torch

# the model's values where a field is not the state: slowness squared,
# damping, TTI anisotropy and angles, elastic moduli and buoyancy (SI)
VAL = {"m": 2.5e-7, "damp": 0.0, "epsilon": 0.1, "delta": 0.05,
       "theta": 0.2, "phi": 0.3, "lam": 8e9, "mu": 6e9, "b": 4.8e-4}
SHAPE = (512, 512, 512)
PHYSICS = ("acoustic", "tti", "elastic")


def timed(launch):
    """(median, least, most) of 3 means of 5 launches, after a warm-up."""
    launch()
    torch.cuda.synchronize()
    means = []
    for _ in range(3):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(5):
            launch()
        e.record()
        torch.cuda.synchronize()
        means.append(s.elapsed_time(e) / 5)
    return statistics.median(means), min(means), max(means)


def fingerprint(tensors):
    """(sum, xor) over the int32 bit patterns of every element."""
    total, x = 0, 0
    for t in tensors:
        bits = t.contiguous().view(torch.int32).reshape(-1)
        total += int(bits.to(torch.int64).sum())
        while bits.numel() > 1:                 # xor by halving
            if bits.numel() % 2:
                bits = torch.cat([bits, bits.new_zeros(1)])
            bits = bits[0::2] ^ bits[1::2]
        x ^= int(bits[0])
    return total, x


def print_registers(root):
    from repro_torch.kernels import _build
    for n, b in _build.build_all().items():
        regs, cur = [], None
        for ln in b.log.splitlines():
            if "Compiling entry" in ln:
                cur = ln.split("_Z")[1][:30] if "_Z" in ln else ln[-30:]
            if "Used" in ln and "registers" in ln:
                regs.append(f"{cur}:"
                            f"{ln.split('Used')[1].split(',')[0].strip()}")
        print(root, n, regs, flush=True)


def launch_args(name, order, T, smoke, dev):
    """(spec, physics, kernel arguments) of one shot at SHAPE: random
    state, the VAL params, the paper case's source and receivers."""
    from repro_torch.core.temporal_blocking import TBPlan
    from repro_torch.kernels import ops, tb_physics as phys
    p = phys.PHYSICS[name]
    fc = smoke.full_case(name, dev)
    plan = TBPlan((32, 32), T, p.step_radius(order))
    gen = torch.Generator(device=dev).manual_seed(0)
    state = tuple(torch.randn(SHAPE, generator=gen, device=dev) * 0.01
                  for _ in p.state_fields)
    if name == "elastic":          # velocities ~1e-6 of the stresses
        state = tuple(s * (1e-6 if i < 3 else 1.0)
                      for i, s in enumerate(state))
    params = {f: torch.full(SHAPE, VAL[f], device=dev)
              for f in p.param_fields}
    spec, st, rt, ppads = ops.prepare_tiles(plan, p, state[0], params, fc.g,
                                            fc.gr, order, fc.dt, fc.spacing)
    batched = hasattr(ops, "stack_tables")
    if batched:
        state = tuple(f[None] for f in state)
    src_dcmp = fc.g.src_dcmp[None] if batched else fc.g.src_dcmp
    pads, sc, sv, rc, rw = ops.tile_operands(spec, state, src_dcmp, st, rt,
                                             0)
    return spec, p, (pads, ppads, sc, sv, rc, rw)


def plan_of(ker, spec, p):
    for fn in ("launch_plan", "stream_plan"):
        if hasattr(ker, fn):
            try:
                return f"plan {getattr(ker, fn)(spec, p)}"
            except ValueError as e:
                return f"plan refused ({e})"
    return "first schedule"


def forced_plans(ker, spec, p, each):
    """The schedules to time: [None] for the one the checkout picks, or
    with `each` the first schedule, the z-streamed sub-tile where the
    checkout's kernel has one that fits, and the cluster-shared trapezoid
    (B5) where it has one (launch plans to force)."""
    if not each or not hasattr(ker, "launch_plan"):
        return [None]
    plans = ["first"]
    try:
        if ker._KERNELS[p.name].stream_from_halo is not None:
            plans.append(ker.stream_plan(spec, p))
    except ValueError:
        pass
    try:
        if hasattr(ker, "cluster_plan"):
            plans.append(ker.cluster_plan(spec, p))
    except ValueError:
        pass
    return plans


@contextlib.contextmanager
def forcing(ker, plan):
    """Launches inside take `plan` ("first": the first schedule; None:
    whatever the checkout's `launch_plan` picks)."""
    if plan is None:
        yield
        return
    chosen = ker.launch_plan
    ker.launch_plan = lambda spec, p: None if plan == "first" else plan
    try:
        yield
    finally:
        ker.launch_plan = chosen


def main(argv):
    root = argv[0]
    grid = "--grid" in argv[1:]
    each = "--each-schedule" in argv[1:]
    names = PHYSICS
    if "--physics" in argv:
        names = tuple(argv[argv.index("--physics") + 1].split(","))
    sys.path.insert(0, root + "/src")
    sys.path.insert(0, root)
    import chip_smoke as smoke
    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil_tb as ker

    print_registers(root)
    dev = torch.device("cuda")
    configs = ([(n, order, T) for n in names for order in (4, 8, 12)
                for T in (1, 2, 4)] if grid else [(n, 4, 4) for n in names])
    for name, order, T in configs:
        tag = f"{root} {name} order {order} T={T}"
        try:
            spec, p, args = launch_args(name, order, T, smoke, dev)
        except (ValueError, RuntimeError, torch.cuda.OutOfMemoryError) as e:
            print(f"{tag}: not run: {type(e).__name__}: "
                  f"{str(e).splitlines()[0][:200]}", flush=True)
            continue
        for forced in forced_plans(ker, spec, p, each):
            with forcing(ker, forced):
                run_one(ker, spec, p, args, tag)
            torch.cuda.empty_cache()
        if not grid and name != "elastic" and hasattr(ops, "stack_tables"):
            pads, ppads, sc, sv, rc, rw = args
            args2 = (tuple(torch.cat([x, x]) for x in pads), ppads,
                     *(torch.cat([x, x]) for x in (sc, sv, rc, rw)))
            run_one(ker, spec, p, args2, tag, fingerprints=False)
            del args2
        args = None
        torch.cuda.empty_cache()


def run_one(ker, spec, p, args, tag, fingerprints=True):
    """Time one launch of `args` on the schedule the checkout's
    `launch_plan` gives (B shots: the leading axis), print its time, plan
    and (for one shot) fingerprints, or why it did not run."""
    B = args[0][0].shape[0] if args[0][0].dim() == 4 else 1
    try:
        # the params' copies made once, as a propagation makes them
        kw = ({"param_copies": ker.param_copies(spec, p, args[1])}
              if hasattr(ker, "param_copies") else {})
        t = timed(lambda: ker.tb_time_tile(spec, p, *args, **kw))
        line = (f"{tag} B={B}: {t[0]:.3f} ms (least {t[1]:.3f}, most "
                f"{t[2]:.3f}); {plan_of(ker, spec, p)}")
        if fingerprints:
            out, rec = ker.tb_time_tile(spec, p, *args, **kw)
            line += (f"; fingerprints: fields {fingerprint(out)}, partials "
                     f"{fingerprint((rec + 0.0,))}")
            del out, rec
        print(line, flush=True)
    except (ValueError, RuntimeError, torch.cuda.OutOfMemoryError) as e:
        print(f"{tag} B={B} ({plan_of(ker, spec, p)}): not run: "
              f"{type(e).__name__}: {str(e).splitlines()[0][:200]}",
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])

"""Time the TB kernels of one checkout of the port on the card, to compare
two versions in one call (run them in turns: parent, change, change,
parent):

    python3 tools/kernel_ab.py <checkout root>

Prints the registers ptxas gives each kernel instantiation, then, at the
paper's 512^3 shapes (tile 32, T = 4, order 4, no sources), the kernel
alone per physics — the median, least and most of 3 means of 5 launches
after a warm-up, by CUDA events — for one shot and, where the checkout
has the shot-batched launch, for two (acoustic and TTI).  Needs a card.
"""
import statistics
import sys

import torch

# the model's values where a field is not the state: slowness squared,
# damping, TTI anisotropy and angles, elastic moduli and buoyancy (SI)
VAL = {"m": 2.5e-7, "damp": 0.0, "epsilon": 0.1, "delta": 0.05,
       "theta": 0.2, "phi": 0.3, "lam": 8e9, "mu": 6e9, "b": 4.8e-4}
SHAPE = (512, 512, 512)


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


def main(root):
    sys.path.insert(0, root + "/src")
    from repro_torch.core.temporal_blocking import TBPlan
    from repro_torch.kernels import _build, ops, tb_physics as phys
    from repro_torch.kernels import stencil_tb as ker

    for n, b in _build.build_all().items():
        regs, cur = [], None
        for ln in b.log.splitlines():
            if "Compiling entry" in ln:
                cur = ln.split("_Z")[1][:30] if "_Z" in ln else ln[-30:]
            if "Used" in ln and "registers" in ln:
                regs.append(f"{cur}:"
                            f"{ln.split('Used')[1].split(',')[0].strip()}")
        print(root, n, regs, flush=True)

    batched = hasattr(ops, "stack_tables")
    dev = torch.device("cuda")
    for name in ("acoustic", "tti", "elastic"):
        p = phys.PHYSICS[name]
        plan = TBPlan((32, 32), 4, p.step_radius(4))
        gen = torch.Generator(device=dev).manual_seed(0)
        state = tuple(torch.randn(SHAPE, generator=gen, device=dev) * 0.01
                      for _ in p.state_fields)
        if name == "elastic":          # velocities ~1e-6 of the stresses
            state = tuple(s * (1e-6 if i < 3 else 1.0)
                          for i, s in enumerate(state))
        params = {f: torch.full(SHAPE, VAL[f], device=dev)
                  for f in p.param_fields}
        spec, st, rt, ppads = ops.prepare_tiles(plan, p, state[0], params,
                                                None, None, 4, 1e-3,
                                                (10.0,) * 3)
        if batched:
            state = tuple(f[None] for f in state)
        pads, sc, sv, rc, rw = ops.tile_operands(spec, state, None, st, rt,
                                                 0)
        del state
        args = (pads, ppads, sc, sv, rc, rw)
        t = timed(lambda: ker.tb_time_tile(spec, p, *args))
        print(f"{root} {name} B=1: {t[0]:.3f} ms (least {t[1]:.3f}, most "
              f"{t[2]:.3f})", flush=True)
        if batched and name != "elastic":
            args2 = (tuple(torch.cat([x, x]) for x in pads), ppads,
                     *(torch.cat([x, x]) for x in (sc, sv, rc, rw)))
            t = timed(lambda: ker.tb_time_tile(spec, p, *args2))
            print(f"{root} {name} B=2: {t[0]:.3f} ms (least {t[1]:.3f}, "
                  f"most {t[2]:.3f})", flush=True)
            del args2
        del args, pads, ppads, params
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1])

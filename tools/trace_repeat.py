"""Whether the 512^3 acoustic paper case repeats itself bit for bit on the
card: main-acoustic's case (order 4, its plan and depth) run RUNS times
in bf16 through `ops.acoustic_tb_propagate`, each run's final fields and
traces held against the first's.  Prints, for each later run, whether
its fields and its traces equal the first's bit for bit and the traces'
max|diff| / max|trace|: what the receivers' segment sum
(`ops.combine_rec_partials`) makes of the order in which the card's
atomic adds land, the fields being bit-equal.

    python3 tools/trace_repeat.py

Builds only the acoustic kernel's library.  Needs one card.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import _build  # noqa: E402

RUNS = 3


def main():
    smi = cs.phase_environment()
    dev = torch.device("cuda", 0)
    _build.build_all(["stencil_tb"])
    fc = cs.bf16_case(cs.full_case("acoustic", dev))
    plan = cs.plan_for(fc.physics, cs.T_TB)
    first = fc.run(plan)
    for k in range(1, RUNS):
        final, recs = fc.run(plan)
        fields = all(torch.equal(a, b) for a, b in zip(final, first[0]))
        cs.say("trace-repeat", f"acoustic {cs.SHAPE} nt={fc.nt} "
               f"T={plan.T} tile {plan.tile} in bf16, run {k + 1} "
               f"vs run 1: fields bit-equal {fields}, traces bit-equal "
               f"{torch.equal(recs, first[1])}, traces max|diff| / "
               f"max|trace| {cs.max_rel(recs.float(), first[1].float()):.3e}"
               f" [{smi}]")
        if not fields:
            raise AssertionError("the fields differ from run to run")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The paper's cases beyond order 4 on the card, without the rest of
`chip_smoke.py`: each case's plan, schedule, launches, TB and SB run
times, kernel time a launch against its bound, peak memory, and its
agreement with the Listing-1 reference (`chip_smoke.phase_paper_case`).

    python3 tools/paper_cases.py [--only tti-12,elastic-8]

`--only` names cases as physics-order; default: the six cases
`chip_smoke.py` runs as its paper-* phases.  A case that fails prints its
error and the others still run; the exit code is 1 if any failed.
"""
import argparse
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="comma list of physics-order, e.g. tti-12")
    args = ap.parse_args()
    cases = cs.PAPER_EXTRA
    if args.only:
        cases = [(p, int(o)) for p, o in
                 (c.split("-") for c in args.only.split(","))]
    smi = cs.phase_environment()
    dev = torch.device("cuda", 0)
    cs.timed("build", cs.phase_build)
    records, failed = [], []
    t0 = time.perf_counter()
    for name, order in cases:
        try:
            records.append(cs.timed(f"paper-{name}-O{order}",
                                    cs.phase_paper_case, name, order, smi,
                                    dev))
        except Exception:                  # report it, run the next case
            traceback.print_exc()
            failed.append(f"{name}-{order}")
            torch.cuda.empty_cache()
    cs.say_paper_table(records, smi)
    cs.say("time", f"total {time.perf_counter() - t0:.1f} s")
    if failed:
        print("failed: " + ", ".join(failed), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

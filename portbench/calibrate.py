"""Readings the check's limits are set from, for one cell, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2 --seconds 30 [--out chiprun_out/cal.jsonl]

For each seed, a whole run of the cell (set-up, the window at the cell's
own load, the check) as ``run.py`` makes it, printing the numbers the
check compares; for the control seeds also the numbers of the control:
the reference computed in bfloat16 put in the program's place, judged by
the same comparison. The limits go between the largest sound reading and
the smallest control reading (PERF.md says how). Benchmark runs never run
the control. Needs the card.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    if harness.program_knobs():
        print(f"the program's switches {harness.program_knobs()} are set",
              file=sys.stderr)
        return 2
    control = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a", encoding="utf-8") if args.out else None
    t_start = T_START
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            r = harness.run_cell(args.workload, seed, args.seconds, False,
                                 device="cuda", t_start=t_start,
                                 control=seed in control)
            t_start = None
            row = {"workload": args.workload, "seed": seed,
                   "correct": r["correct"], "attempted": r["attempted"],
                   "check": {k: v["value"] for k, v in r["check"].items()},
                   "control": r.get("control"),
                   "metrics": {k: v["value"]
                               for k, v in r["metrics"].items()}}
            print(json.dumps(row), flush=True)
            if out is not None:
                out.write(json.dumps(row) + "\n")
                out.flush()
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

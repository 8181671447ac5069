"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for. With ``--trace 0`` the result's metrics are the cell's end-to-end
metrics; with ``--trace 1`` a shorter traced window gives its per-layer
metrics, the device's busy time and a breakdown. The last line of standard
output is the result (JSON); the last lines of standard error are the
numbers the check compared, each beside its limit. Exits non-zero, and
prints no result, when there is no card or too few, when one of the
program's ``RAYTPU_*`` switches is set in the environment (the cell
measures the program's defaults), when the program is missing, or when
the JAX package or JAX itself was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench import harness

    chips = int(harness.workload(harness.benchmark(), args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    knobs = harness.program_knobs()
    if knobs:
        print(f"the program's switches {', '.join(knobs)} are set: the "
              f"cell measures its defaults; no result", file=sys.stderr)
        return 2
    print(f"card: {_power_limit()}", file=sys.stderr)
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

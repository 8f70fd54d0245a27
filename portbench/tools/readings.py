"""The readings a cell's limits are set from, on the card, in one process.

For each seed, a short run of the cell (program), and for a few seeds the
control: the plain reference in the program's place, one precision below
the one the configuration states (``reference/controls.py``).
Prints one JSON line a run: the numbers compared, beside the limits
currently in ``portbench/limits/<cell>.json``.

    python portbench/tools/readings.py --workload serve_crnn_b64 \\
        --seeds 12 --control-seeds 3 --seconds 2 --control-seconds 8

The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    from portbench.harness import guard
    guard.install()
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    # the control is the plain reference, far slower than the program:
    # its window must still reach every input the check compares
    p.add_argument("--control-seconds", type=float, default=8.0)
    p.add_argument("--first-seed", type=int, default=3_000_000_019)
    # faults of the cell's runner (its FAULTS, by name, comma-separated),
    # each planted in the program on --fault-seeds seeds
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", type=int, default=3)
    args = p.parse_args(argv)

    from portbench.harness import cell
    from portbench.reference import controls
    _, c, config, mix, _ = cell.find(ROOT, args.workload)
    faults = {f.__name__: f for f in
              cell.runner_module(mix["runner"]).FAULTS}
    control = controls.control_for(config, mix)
    runs = [("program", args.first_seed + i, None, None, args.seconds)
            for i in range(args.seeds)]
    runs += [("control", args.first_seed + 1000 + i, control, None,
              args.control_seconds) for i in range(args.control_seeds)]
    for j, name in enumerate(n for n in args.faults.split(",") if n):
        runs += [(name, args.first_seed + 2000 + 100 * j + i, None,
                  faults[name], args.seconds)
                 for i in range(args.fault_seeds)]
    for kind, seed, ctl, fault, seconds in runs:
        detail = {}
        res = cell.execute(ROOT, args.workload, seed, seconds, False,
                           control=ctl, detail=detail, fault=fault)
        print(json.dumps({"workload": args.workload, "kind": kind,
                          "seed": seed, "correct": res["correct"],
                          "checks": res["checks"],
                          "metrics": res["metrics"], "detail": detail}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

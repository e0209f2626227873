#!/usr/bin/env python3
"""The readings that set the limits of ``correct``, on the card.

    python3 benchmark/control.py --workload laplace.d5.heavy --seeds 1 2 3
    python3 benchmark/control.py --workload laplace.d5.heavy --sound \\
        --seeds 1 2 3 4 5 6 7 8 9 10 11 12

Runs a cell's set-up and one whole run, then judges that run's output with
every seed (``harness/check.py``), in one process, and prints one JSON
line per seed with each compared number.  Without ``--sound`` the run is
the control: the program's own float32 path, every screen passer
accepted without the float64 recheck (``SearchConfig.f64_skip_below``
above any relative residual), the precision below the one the
configuration states; its smallest readings are the upper readings.
With ``--sound`` the run is the cell as configured, and its largest
readings are the lower ones.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import benchmark.run as harness  # noqa: E402
from benchmark.harness import check, spec  # noqa: E402

CONTROL = {"f64_skip_below": 1.0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sound", action="store_true")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not args.sound:
        cell.traffic = dict(cell.traffic, search_config=dict(
            cell.traffic.get("search_config", {}), **CONTROL))
    # the harness judges its run once; judge the same run with every seed
    by_seed = {}
    judge = check.judge

    def judge_every_seed(runs, db, config, audit, seed):
        for s in args.seeds:
            by_seed[s] = judge(runs, db, config, audit, s)[0]
        return judge(runs, db, config, audit, seed)

    check.judge = judge_every_seed
    _, notes = harness.run_cell(cell, args.seeds[0], 0.0, False)
    for n in notes:
        print(f"check: {n}", file=sys.stderr)
    for s in args.seeds:
        print(json.dumps({"workload": cell.name, "sound": args.sound,
                          "seed": s, "correct_under_limits":
                          check.passed(by_seed[s]),
                          "checks": {k: c["value"] for k, c in
                                     by_seed[s].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The controls of the cells' checks: the plain reference put in the
program's place at a lower precision, or with a guarantee broken, and
judged by the cell's own comparison against the exact reference. A
control has to come out not correct; its smallest reading over seeds is
the upper reading of the comparison's limit.

    python -m cdsbench.control --workload CELL --precision P --seed N ...

prints one JSON line per seed: each compared number with its limit, and
the pairs or matches compared. Each cell's driver runs its own control
(`control(run, precision)`, beside its `check`); this module runs no
program code and decides nothing in a benchmark run, whose runs do not
run it.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import harness as H


def control(cell: str, seed: int, precision: str, device: str,
            traffic: dict = None) -> dict:
    from .run import Run
    run = Run(cell, seed, 0, False, device)
    run.traffic.update(traffic or {})
    try:
        driver = H.load_plugin("drivers", run.workload["driver"])
        compared = driver.control(run, precision)
    finally:
        run.close()
    return {"workload": cell, "seed": seed, "precision": precision,
            "correct": all(v <= lim for v, lim in compared.values()),
            "compared": {k: {"value": v, "limit": lim}
                         for k, (v, lim) in compared.items()},
            "of": run.rec.get("checked", 0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m cdsbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--precision", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for s in args.seed:
        print(json.dumps(control(args.workload, s, args.precision,
                                 args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

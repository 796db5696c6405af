"""The control of `correct`: the plain reference put in the program's
place, computed in float32, the precision below the configuration's
float64, and judged by the same comparison and limits as a run.

    python3 -m ytbench.control --workload <cell> --seeds <n> [<n> ...]

generates each seed's tables at the cell's own size, works out every
answer of every substitution the seed draws in float64 and in float32,
and prints one JSON line per seed: the float32 answers' readings, and
whether the cell's limits pass them (they must not). It needs no card;
the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ytbench import harness, spec


def readings(p: harness.Plan, tables: dict) -> dict:
    """The readings of the float32 reference's answers against float64's,
    over every substitution of every query of the cell's traffic."""
    merged = harness.merged_tables(tables)
    wrong, err, checked = 0, 0.0, 0
    for name, q in p.queries.items():
        module = q["module"]
        want = module.answers(merged, p.substitutions[name], np.float64)
        got = module.answers(merged, p.substitutions[name], np.float32)
        for g, w in zip(got, want):
            wr, e = module.compare(module.as_rows(g), w)
            wrong += wr
            err = max(err, e)
            checked += 1
    return {"answers": checked, "failed": 0, "wrong_answers": wrong,
            "max_rel_err": err}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    limits = spec.cell(args.workload)["limits"]
    for seed in args.seeds:
        p = harness.plan(args.workload, seed)
        compared = harness.checks(readings(p, harness.generate(p)), limits)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_passes": all(harness.passes(c) for c in
                                                compared.values()),
                          "checks": compared}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

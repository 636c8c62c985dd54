"""The readings that the correctness limits are set from; not part of a
benchmark run.

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3 ... \\
        [--seconds 0] [--out chiprun_out/control.jsonl]

For each seed, in one process: the cell's set-up, warm-up and a window
(``--seconds`` 0 runs it just past the checked period), then the check's
numbers for the program (its lower readings) and for the control, the
reference computed in TF32 put in the program's place (its upper
readings). One JSON line a seed; at the end, per number, the largest
program reading, the smallest control reading and their ratio.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from . import run, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    rows = []
    for seed in args.seeds:
        res, _ = run.run_cell(cell, seed, args.seconds, False, dev,
                              control=True)
        row = {"seed": seed, "correct": res["correct"],
               "program": {k: v[0] for k, v in res["check"].items()},
               "control": res["control"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    lower = {k: max(r["program"][k] for r in rows) for k in rows[0]["program"]}
    upper = {k: min(r["control"][k] for r in rows) for k in lower}
    summary = {k: {"lower": lower[k], "upper": upper[k],
                   "ratio": upper[k] / lower[k] if lower[k] else None}
               for k in lower}
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in rows + [{"summary": summary}]:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Compare this tree with another checkout (a parent commit's, unpacked
with ``git archive``) on one card, in turns: other, this, this, other. An
experiment, not part of the port.

    python3 experiments/parent_turns.py OTHER_DIR [--kernels] [--benches]
        [--bench NAME ...] [--rounds N]

from the repository root (default both groups; ``--bench`` keeps the named
benches only; ``--rounds`` repeats the four turns). Each turn runs, from that
tree's root and in a process of its own (so each tree builds and loads its
own kernels):

  * ``--kernels``: ``chip_smoke.kernel_times()`` of this file's tree,
    imported with the other tree first on ``sys.path``, so both trees are
    timed by the same code through the entry points they share (the
    kernels the last redesigns touched, the t rsplit=0 CAAR and both rings
    among them; a ring's graph time where that tree's launch clears its
    state);
  * ``--benches``: the port's benches, ``python -m
    tinman_sandbox_tpu_torch.bench`` raw, ``--ne 30``, ``--ne 30 --ring``,
    ``--ne 30 --rk --hypervis-nu 1e15``, ``--ne 30 --prim --hypervis-nu
    1e15``, ``--layout row`` and ``--layout row --ne 30``.

Prints the card's name and power limit first, then one JSON line a run:
{"tree": "other" or "this", "turn": 0, 1, ... (four a round), "what": ...
"result": ...}.
Without a card the runs fail and the script exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCHES = {
    "raw": [],
    "assembled": ["--ne", "30"],
    "ring": ["--ne", "30", "--ring"],
    "dynamics": ["--ne", "30", "--rk", "--hypervis-nu", "1e15"],
    "prim": ["--ne", "30", "--prim", "--hypervis-nu", "1e15"],
    "row_raw": ["--layout", "row"],
    "row_assembled": ["--layout", "row", "--ne", "30"],
}
KERNEL_TIMES = (
    "import importlib.util as u, sys; sys.path.insert(0, '.'); "
    "s = u.spec_from_file_location('cs', {path!r}); "
    "m = u.module_from_spec(s); s.loader.exec_module(m); m.kernel_times()")


def _last_json(out: str):
    for line in reversed(out.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    raise ValueError("no JSON line in the output")


def _run(cwd: str, argv: list, timeout: int = 900):
    proc = subprocess.run(argv, cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode:
        raise RuntimeError(f"{argv} in {cwd} exited {proc.returncode}:\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return _last_json(proc.stdout)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", help="root of the other tree")
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--benches", action="store_true")
    ap.add_argument("--bench", action="append", choices=sorted(BENCHES),
                    help="run only these benches (repeatable)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="repeat the four turns this many times")
    args = ap.parse_args(argv)
    benches = {k: v for k, v in BENCHES.items()
               if not args.bench or k in args.bench}
    groups = [g for g in ("kernels", "benches") if getattr(args, g)] or [
        "kernels", "benches"]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    trees = [("other", os.path.abspath(args.other)), ("this", HERE),
             ("this", HERE), ("other", os.path.abspath(args.other))]
    trees *= args.rounds
    smoke = os.path.join(HERE, "chip_smoke.py")
    for turn, (label, root) in enumerate(trees):
        if "kernels" in groups:
            res = _run(root, [sys.executable, "-c",
                              KERNEL_TIMES.format(path=smoke)])
            print(json.dumps({"tree": label, "turn": turn,
                              "what": "kernel_times", "result": res}),
                  flush=True)
        if "benches" in groups:
            for name, extra in benches.items():
                res = _run(root, [sys.executable, "-m",
                                  "tinman_sandbox_tpu_torch.bench", *extra])
                print(json.dumps({"tree": label, "turn": turn, "what": name,
                                  "result": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

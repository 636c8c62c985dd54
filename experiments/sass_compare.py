#!/usr/bin/env python3
"""Compare the machine code of one CUDA source of this tree with the same
source of another checkout (a parent commit's, unpacked with ``git
archive``). An experiment, not part of the port.

    python3 experiments/sass_compare.py OTHER_DIR [--source caar] [--diff N]

from the repository root. Builds ``tinman_sandbox_tpu_torch/csrc/<source>.cu``
of both trees with the port's nvcc flags (``kernels/_build.py``), the two
nvcc runs at once, into ``build/experiments/``, disassembles each library
with ``cuobjdump -sass`` and prints one JSON line a kernel: its name (the
anonymous namespace's hash taken out, since it differs between the two
files), its instructions in each build and whether the two are the same
instruction for instruction (addresses and encodings left out); with
``--diff N``, for a kernel in both builds that differs, also its first N
differing instruction pairs. Needs the CUDA toolkit (nvcc and cuobjdump),
not a card.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tinman_sandbox_tpu_torch.kernels import _build  # noqa: E402

_HASH = re.compile(r"_GLOBAL__N__[0-9a-f]+_")
# an instruction's address (/*0040*/) and its encoding (/* 0x... */)
_CODE = re.compile(r"/\*\s*(0x)?[0-9a-f]{4,}\s*\*/")


def _functions(sass: str) -> dict:
    """{kernel: [instruction, ...]} of a ``cuobjdump -sass`` listing."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            name = _HASH.sub("", m.group(1))
            out[name] = []
        elif name:
            ins = " ".join(_HASH.sub("", _CODE.sub("", line)).split())
            if ins:
                out[name].append(ins)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", help="root of the other tree")
    ap.add_argument("--source", default="caar", choices=sorted(_build.SOURCES))
    ap.add_argument("--diff", type=int, default=0,
                    help="differing instruction pairs to print a kernel")
    args = ap.parse_args(argv)
    out = os.path.join(ROOT, "build", "experiments")
    os.makedirs(out, exist_ok=True)
    rel = os.path.join("tinman_sandbox_tpu_torch", "csrc",
                       _build.SOURCES[args.source])
    trees = {"other": os.path.abspath(args.other), "this": ROOT}
    procs = {}
    for label, root in trees.items():
        lib = os.path.join(out, f"sass_{args.source}_{label}.so")
        procs[label] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build._flags(args.source), "-o", lib,
             os.path.join(root, rel)], stderr=subprocess.PIPE, text=True))
    listings = {}
    for label, (lib, proc) in procs.items():
        err = proc.communicate()[1]
        if proc.returncode:
            raise RuntimeError(f"nvcc ({label}): {err[-2000:]}")
        cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
        listings[label] = _functions(subprocess.run(
            [cuobjdump, "-sass", lib], capture_output=True, text=True,
            check=True).stdout)
    a, b = listings["other"], listings["this"]
    for name in sorted(set(a) | set(b)):
        line = {"source": rel, "kernel": name,
                "other_instructions": len(a.get(name, [])),
                "this_instructions": len(b.get(name, [])),
                "same": a.get(name) == b.get(name)}
        if args.diff and name in a and name in b and not line["same"]:
            line["first_differences"] = [
                (i, x, y) for i, (x, y) in enumerate(zip(a[name], b[name]))
                if x != y][:args.diff]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

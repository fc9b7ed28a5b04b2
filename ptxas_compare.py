#!/usr/bin/env python3
"""Compare ptxas's register, stack and spill lines of two trees' kernels,
object by object (plonky_tpu_torch/_build/build.log, one "== object"
section each), to show that a change left a build's machine code as it
was.

    python3 ptxas_compare.py OLD NEW

Builds each tree's kernels in a process of its own (from the tree's
directory; OLD is an unpacked earlier commit, e.g. under the gitignored
.cache/), prints one JSON line per object of OLD (equal or not, with both
sides' lines where they differ) and one for every object only NEW has,
then the card's nvidia-smi name/power line.  Exits 1 unless every object
of OLD has the same lines in NEW.  Needs nvcc; the card is not used.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys


def ptxas_lines(tree: str) -> dict:
    """Build `tree`'s kernels and read its build log: object -> the ptxas
    lines naming an entry function, registers, stack or spills."""
    subprocess.run([sys.executable, "-c",
                    "from plonky_tpu_torch import _cuda; _cuda.build()"],
                   cwd=tree, check=True)
    out, obj = {}, None
    with open(os.path.join(tree, "plonky_tpu_torch", "_build", "build.log")) as f:
        for ln in f:
            m = re.match(r"== (\S+)", ln)
            if m:
                obj = m.group(1).replace(".cu", "")
                out[obj] = []
            elif obj and re.search(r"registers|spill|stack|Compiling entry", ln):
                out[obj].append(ln.strip())
    return out


def main() -> int:
    old_tree, new_tree = (os.path.abspath(a) for a in sys.argv[1:3])
    old, new = ptxas_lines(old_tree), ptxas_lines(new_tree)
    same = True
    for obj, lines in old.items():
        equal = new.get(obj) == lines
        same &= equal
        rec = {"object": obj, "equal": equal, "lines": len(lines)}
        if not equal:
            rec.update(old=lines, new=new.get(obj))
        print(json.dumps(rec), flush=True)
    for obj in new.keys() - old.keys():
        print(json.dumps({"object": obj, "only_new": True, "lines": new[obj]}),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"same": same}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())

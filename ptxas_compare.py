#!/usr/bin/env python3
"""Compare ptxas's register, stack and spill lines of two trees' kernels,
entry function by entry function within each object
(plonky_tpu_torch/_build/build.log, one "== object" section each), to
show that a change left a build's machine code as it was.

    python3 ptxas_compare.py OLD NEW

Builds each tree's kernels in a process of its own (from the tree's
directory; OLD is an unpacked earlier commit, e.g. under the gitignored
.cache/), prints one JSON line per object of OLD (equal or not, with both
sides' lines of each entry that differs) and one for every object or
entry only NEW has, then the card's nvidia-smi name/power line.  Exits 1
unless every entry of OLD has the same lines in NEW (an entry NEW adds
beside them is reported, not counted against it).  Needs nvcc; the card
is not used.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys


def ptxas_lines(tree: str) -> dict:
    """Build `tree`'s kernels and read its build log: object -> function
    (an entry, or a device function ptxas reports properties for) -> its
    ptxas lines (registers, stack and spills)."""
    subprocess.run([sys.executable, "-c",
                    "from plonky_tpu_torch import _cuda; _cuda.build()"],
                   cwd=tree, check=True)
    out, obj, entry = {}, None, ""
    with open(os.path.join(tree, "plonky_tpu_torch", "_build", "build.log")) as f:
        for ln in f:
            m = re.match(r"== (\S+)", ln)
            if m:
                obj, entry = m.group(1).replace(".cu", ""), ""
                out[obj] = {}
                continue
            m = re.search(r"Compiling entry function '([^']+)'|Function properties "
                          r"for (\S+)", ln)
            if obj and m:
                # a function of internal linkage carries a hash of its
                # compilation unit's path in its name (_INTERNAL_<hash>_),
                # which differs between two trees' checkouts
                entry = re.sub(r"_INTERNAL_[0-9a-f]+_", "_INTERNAL_",
                               m.group(1) or m.group(2))
            if obj and re.search(r"registers|spill|stack|Compiling entry", ln):
                out[obj].setdefault(entry, []).append(ln.strip())
    return out


def main() -> int:
    old_tree, new_tree = (os.path.abspath(a) for a in sys.argv[1:3])
    old, new = ptxas_lines(old_tree), ptxas_lines(new_tree)
    same = True
    for obj, entries in old.items():
        now = new.get(obj, {})
        differ = {e: {"old": lines, "new": now.get(e)}
                  for e, lines in entries.items() if now.get(e) != lines}
        same &= not differ
        rec = {"object": obj, "equal": not differ, "entries": len(entries),
               "lines": sum(len(v) for v in entries.values())}
        if differ:
            rec["differ"] = differ
        added = sorted(now.keys() - entries.keys())
        if added:
            rec["only_new"] = {e: now[e] for e in added}
        print(json.dumps(rec), flush=True)
    for obj in new.keys() - old.keys():
        print(json.dumps({"object": obj, "only_new": True, "entries": new[obj]}),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"same": same}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())

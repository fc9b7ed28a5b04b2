#!/usr/bin/env python3
"""Compare ptxas's register, stack and spill lines of two trees' kernels,
entry function by entry function within each object
(plonky_tpu_torch/_build/build.log, one "== object" section each), and
the sha256 of each function's machine code (cuobjdump -sass), to show
that a change left a build's machine code as it was.

    python3 ptxas_compare.py OLD NEW [--changed OBJECT:FUNCTION ...]

Builds each tree's kernels in a process of its own (from the tree's
directory; OLD is an unpacked earlier commit, e.g. under the gitignored
.cache/), prints one JSON line per object of OLD (equal or not, with both
sides' lines of each entry that differs, both SASS digests and
instruction counts of the object and of each function whose SASS
differs) and one for every object or entry only NEW has, then the card's
nvidia-smi name/power line.  Exits 1 unless every entry of OLD has the
same lines in NEW and every function of OLD the same SASS (an entry NEW
adds beside them is reported, not counted against it), except the
functions named after --changed (OBJECT:FUNCTION, FUNCTION a part of the
mangled name, e.g. ntt_kernels_l12:ntt_pass_kernel for a kernel that the
change redesigns), which are reported and not counted.  Needs
nvcc and cuobjdump; the card is not used.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys

# A function of internal linkage carries a hash of its compilation unit's
# path in its name (_INTERNAL_<hash>_), which differs between two trees'
# checkouts.
INTERNAL = re.compile(r"_INTERNAL_[0-9a-f]+_")


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
                entry = INTERNAL.sub("_INTERNAL_", m.group(1) or m.group(2))
            if obj and re.search(r"registers|spill|stack|Compiling entry", ln):
                out[obj].setdefault(entry, []).append(ln.strip())
    return out


def sass(tree: str, obj: str) -> tuple:
    """(function -> (sha256, instructions), function -> lines) of its SASS
    listing in an object (cuobjdump -sass), the headers left out, internal
    names' hashes dropped and runs of spaces collapsed, and "*" -> the same
    over the whole object; ({}, {}) where the tree has no such object."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    path = os.path.join(tree, "plonky_tpu_torch", "_build", obj + ".o")
    if not os.path.exists(path):     # the log's link section
        return {}, {}
    text = subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    bodies, fn = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = INTERNAL.sub("_INTERNAL_", m.group(1))
            bodies[fn] = []
        elif fn and ln.strip() and not re.search(r"\.headerflags|code for sm|Fatbin|"
                                                 r"arch =|code version|host =|"
                                                 r"compile_size|identifier", ln):
            # runs of spaces collapsed: cuobjdump pads the instruction
            # column to the object's longest instruction
            bodies[fn].append(" ".join(INTERNAL.sub("_INTERNAL_", ln).split()))
    bodies["*"] = [ln for f in sorted(bodies) for ln in [f] + bodies[f]]

    def digest(body):
        count = sum(1 for ln in body if re.match(r"/\*[0-9a-f]{4,}\*/", ln))
        return hashlib.sha256("\n".join(body).encode()).hexdigest()[:16], count
    return {f: digest(b) for f, b in bodies.items()}, bodies


def first_diff(old: list, new: list) -> list:
    """The first line pair at which two SASS listings differ."""
    for k, (a, b) in enumerate(zip(old, new)):
        if a != b:
            return [k, a.strip(), b.strip()]
    return [min(len(old), len(new)), "(end)", "(end)"]


def main() -> int:
    args = sys.argv[1:]
    changed = ([tuple(c.split(":", 1)) for c in args[args.index("--changed") + 1:]]
               if "--changed" in args else [])
    old_tree, new_tree = (os.path.abspath(a) for a in args[:2])
    old, new = ptxas_lines(old_tree), ptxas_lines(new_tree)
    same = True
    for obj, entries in old.items():
        def exempt(fn, obj=obj):
            return any(o == obj and e in fn for o, e in changed)
        now = new.get(obj, {})
        differ = {e: {"old": lines, "new": now.get(e)}
                  for e, lines in entries.items() if now.get(e) != lines}
        (sass_old, body_old), (sass_new, body_new) = sass(old_tree, obj), sass(new_tree, obj)
        sass_differ = {f: {"old": d, "new": sass_new.get(f), **({} if exempt(f) else {
            "first_diff": first_diff(body_old[f], body_new.get(f, []))})}
            for f, d in sass_old.items() if f != "*" and sass_new.get(f) != d}
        same &= not any(not exempt(f) for f in list(differ) + list(sass_differ))
        rec = {"object": obj, "equal": not differ, "sass_equal": not sass_differ,
               "sass_old": sass_old.get("*"), "sass_new": sass_new.get("*"),
               "changed": sorted(f for f in list(differ) + list(sass_differ) if exempt(f)),
               "entries": len(entries),
               "lines": sum(len(v) for v in entries.values())}
        if differ:
            rec["differ"] = differ
        if sass_differ:
            rec["sass_differ"] = sass_differ
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

#!/usr/bin/env python3
"""Hold the machine code of every CUDA library of two trees to each other:

    python3 tools/sass_ab.py <other tree> [name ...]

builds each library of ``jrl_lbm_torch/kernels/csrc`` (``build.NAMES``, or
the names given) from this checkout and from ``<other tree>`` with this
checkout's ``build.NVCC_FLAGS`` (one ``nvcc`` per source, all started
together), dumps each with ``cuobjdump -sass`` and compares the listings
function by function, instruction by instruction. The anonymous namespace
of a source carries a hash of its path, so its mangled prefix is cut from
the names before they are compared. Libraries that the other tree lacks
are listed apart. Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit), no
card. Prints one JSON line, last: ``same``, ``differ`` (with each
differing function's first differing instruction) and ``only_here``.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+")


def listing(tool: str, lib: str) -> dict:
    """``{function: [instruction, ...]}`` of a library's SASS, the
    instructions without their addresses and encodings."""
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = ANON.sub("<anon>", m.group(1))
            funcs[cur] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if cur is not None and m:
            funcs[cur].append(ANON.sub("<anon>", m.group(1)))
    return funcs


def main() -> int:
    sys.path.insert(0, HERE)
    from jrl_lbm_torch.kernels import build

    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(sys.argv[1])
    names = sys.argv[2:] or list(build.NAMES)
    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(build.nvcc_path()),
                                                     "cuobjdump")
    tmp = tempfile.mkdtemp(prefix="sass_ab_")
    jobs, only_here = {}, []
    for name in names:
        for tag, root in (("here", HERE), ("other", other)):
            src = os.path.join(root, "jrl_lbm_torch", "kernels", "csrc", f"{name}.cu")
            if not os.path.exists(src):
                only_here.append(name)
                continue
            out = os.path.join(tmp, f"{name}-{tag}.so")
            jobs[(name, tag)] = (out, subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-o", out, src],
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE))
    for (name, tag), (_, proc) in jobs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc {name} ({tag}): {proc.stderr.read().decode()}")
    same, differ = [], {}
    for name in names:
        if (name, "other") not in jobs:
            continue
        a, b = (listing(tool, jobs[(name, t)][0]) for t in ("here", "other"))
        diffs = {}
        for fn in sorted(set(a) | set(b)):
            ia, ib = a.get(fn), b.get(fn)
            if ia == ib:
                continue
            if ia is None or ib is None:
                diffs[fn] = "only " + ("here" if ib is None else "in the other tree")
                continue
            k = next((i for i, (x, y) in enumerate(zip(ia, ib)) if x != y), min(len(ia), len(ib)))
            diffs[fn] = {"instructions": [len(ia), len(ib)], "first": k,
                         "here": ia[k] if k < len(ia) else None,
                         "other": ib[k] if k < len(ib) else None}
        if diffs:
            differ[name] = diffs
        else:
            same.append(name)
        print(f"{name}: {'same' if not diffs else f'{len(diffs)} functions differ'} "
              f"({sum(len(v) for v in a.values())} instructions)", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"same": same, "differ": differ, "only_here": only_here}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

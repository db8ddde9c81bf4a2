"""Whether two checkouts of the port compile a kernel to the same SASS.

    python -m falcon_genome_tpu_torch.benchmarks.sass_diff ROOT_A ROOT_B
        [PATTERN]

Builds each checkout's kernel library (in a process of its own with the
ROOT first on ``sys.path``; a library already built is reused), then
compares the SASS (``cuobjdump -sass``) of every function whose mangled
name matches the regular expression PATTERN (default ``pairhmm_kernel``),
instruction by instruction, and their registers and spills (``ptxas
-v``).  Prints one JSON line: the functions found in each library, those
whose SASS is identical, those that differ (with their instruction
counts), and each function's ptxas line in both.  Exits non-zero without
a CUDA toolkit or when a build fails.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

_BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
          "from falcon_genome_tpu_torch.ops import _build; "
          "print(_build.build())")


def built_library(root: Path) -> Path:
    res = subprocess.run([sys.executable, "-c", _BUILD, str(root)],
                         capture_output=True, text=True, timeout=1200)
    if res.returncode != 0:
        raise RuntimeError(f"build of {root} failed: {res.stderr[-3000:]}")
    so = Path(res.stdout.strip().splitlines()[-1])
    if not so.resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"{so} is not {root}'s library")
    return so


def main(argv: list[str]) -> int:
    if len(argv) not in (2, 3):
        print("usage: sass_diff ROOT_A ROOT_B [PATTERN]", file=sys.stderr)
        return 2
    from . import sass
    pattern = argv[2] if len(argv) == 3 else "pairhmm_kernel"
    sos = [built_library(Path(r)) for r in argv[:2]]
    # a function's mangled name carries a hash of its translation unit
    # where it lies in an anonymous namespace: match names without it
    names = [{re.sub(r"_GLOBAL__N__\w+?_\d+_", "_GLOBAL__N_", n): n
              for n in sass.sass_names(so, pattern)} for so in sos]
    ptxas = [[row for row in sass.ptxas_summary(
        so.with_name(so.stem + ".ptxas.txt").read_text())
        if re.search(pattern, row)] for so in sos]
    same, differ = [], {}
    for name in sorted(names[0].keys() & names[1].keys()):
        a, b = (sass.sass_function(so, re.escape(n[name]) + r"\b")
                for so, n in zip(sos, names))
        if [t for _, t in a] == [t for _, t in b]:
            same.append(name)
        else:
            differ[name] = [len(a), len(b)]
    print(json.dumps({
        "roots": argv[:2], "pattern": pattern,
        "functions": [len(n) for n in names],
        "only_a": sorted(names[0].keys() - names[1].keys()),
        "only_b": sorted(names[1].keys() - names[0].keys()),
        "identical": len(same), "differ": differ,
        "ptxas": ptxas}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

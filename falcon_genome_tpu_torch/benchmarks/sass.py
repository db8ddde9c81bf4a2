"""Reading the built kernel library: ``ptxas -v`` reports and the SASS that
``cuobjdump -sass`` prints.

Used by ``chip_smoke.py`` (phase 2 and 7), ``kernel_ab.py`` and
``ablate_sw.py`` to count registers and the instructions of one sweep
step of a kernel.  Needs the
CUDA toolkit's ``cuobjdump``; nothing here runs without a built library.
"""
from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path

FP = re.compile(r"\b(FFMA|FMUL|FADD)\b")
# integer max/min: IMNMX and the DPX forms (VIMNMX, VIMNMX3, VIADDMNMX)
MNMX = re.compile(r"\b\w*MNMX\w*\b")
SHFL_UP = re.compile(r"SHFL\.UP")
# integer multiply-adds (IMAD and its MOV/SHL/IADD forms), which the
# compiler also uses for moves, shifts and adds
IMAD = re.compile(r"\bIMAD")
# the pointer walk's loop: its ballot (VOTE), or the parent design's load
WALK = re.compile(r"\bVOTE\b|\bLDG\b")

_sass_text: dict[Path, str] = {}


class SassError(RuntimeError):
    """The library's SASS lacks what a count needs."""


def ptxas_summary(report: str) -> list[str]:
    """``name: N registers, S B spill stores, L B spill loads`` for every
    kernel in an ``nvcc -Xptxas -v`` report (names demangled with
    c++filt where it exists)."""
    rows, name, spill = [], None, ""
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name:
            spill = f"{m.group(1)} B spill stores, {m.group(2)} B spill loads"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            rows.append([name, f"{m.group(1)} registers, {spill}"])
            name, spill = None, ""
    if rows and shutil.which("c++filt"):
        res = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True)
        if res.returncode == 0:
            for r, d in zip(rows, res.stdout.splitlines()):
                r[0] = re.sub(r"\(.*\)$", "", d.replace(
                    "(anonymous namespace)::", ""))
    return [f"{n}: {v}" for n, v in rows]


def kernel_registers(report: str, pattern: str) -> int | None:
    """Registers of the first kernel in an ``nvcc -Xptxas -v`` report
    whose mangled name matches ``pattern``."""
    name = None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and name and re.search(pattern, name):
            return int(m.group(1))
    return None


def sass_function(so: Path, kernel: str) -> list[tuple[int, str]]:
    """(address, instruction) of the first function in the SASS of the
    built library whose mangled name matches the regular expression
    ``kernel`` (``cuobjdump -sass``, run once per library)."""
    if so not in _sass_text:
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        res = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                             text=True, timeout=300)
        if res.returncode != 0:
            raise SassError(f"cuobjdump failed: {res.stderr[-2000:]}")
        _sass_text[so] = res.stdout
    funcs = re.split(r"\n\s*Function : ", _sass_text[so])
    body = next((f for f in funcs[1:]
                 if re.search(kernel, f.splitlines()[0])), None)
    if body is None:
        raise SassError(f"no {kernel} in the SASS of {so.name}")
    return [(int(a, 16), t) for a, t in
            re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]


def sass_names(so: Path, pattern: str) -> list[str]:
    """Mangled names of the functions in the built library's SASS that
    match the regular expression ``pattern``."""
    sass_function(so, pattern)   # runs cuobjdump; raises if none matches
    return [n for n in re.findall(r"\n\s*Function : (\S+)", _sass_text[so])
            if re.search(pattern, n)]


def sass_loops(ins) -> list[tuple[int, int]]:
    """(first, last) addresses of every loop: a backward branch's target
    and the branch.  A span that holds an ``EXIT`` is no loop: it is the
    way back from out-of-line code placed behind the kernel's end."""
    out = []
    for addr, text in ins:
        m = re.search(r"\bBRA\b[^;]*?0x([0-9a-f]+)", text)
        if m and int(m.group(1), 16) < addr and not any(
                int(m.group(1), 16) <= a <= addr and re.search(r"\bEXIT\b", t)
                for a, t in ins):
            out.append((int(m.group(1), 16), addr))
    return out


def sass_ffma_per_trip(so: Path, kernel: str, unroll: int) -> tuple[int, int]:
    """(FFMAs in the body of ``kernel``'s loop, FFMAs per trip) in the
    SASS of the built library; the body holds ``unroll`` trips."""
    ins = sass_function(so, kernel)
    loop = max((sum(1 for a, t in ins if lo <= a <= hi
                    and re.search(r"\bFFMA\b", t))
                for lo, hi in sass_loops(ins)), default=0)
    if loop <= 0:
        raise SassError(f"no loop with FFMAs in {kernel}'s SASS")
    return loop, loop // unroll


def sass_sweep_counts(so: Path, kernel: str, *, loop_by=FP, count=FP,
                      shfl_per_step: int = 3) -> dict:
    """Instructions of one sweep step of a kernel, from the SASS of the
    built library.  The sweep is the innermost of the loops with the most
    instructions matching ``loop_by``.  A block inside it that a forward
    branch skips and that holds butterfly shuffles (PairHMM's rescale
    test, a warp maximum taken once in 64 steps) is left out, as is the
    out-of-line code behind ``BRA.DIV`` (shuffles of a warp that is not
    converged).  ``shfl_per_step`` ``SHFL.UP`` a step (PairHMM 3: M, I,
    D; Smith-Waterman 2: H, F) say how many steps one trip holds.
    Returns per-step totals, and of them those matching ``count``."""
    ins = sass_function(so, kernel)
    loops = sass_loops(ins)
    if not loops:
        raise SassError(f"no loop in {kernel}'s SASS")
    lo, hi = max(loops, key=lambda r: (
        sum(1 for a, t in ins if r[0] <= a <= r[1] and loop_by.search(t)),
        r[0] - r[1]))
    body = [(a, t) for a, t in ins if lo <= a <= hi]
    cold = (0, 0)
    for a, t in body:
        m = re.search(r"\bBRA\s[^;]*?0x([0-9a-f]+)", t)
        if not m or not a < int(m.group(1), 16) <= hi:
            continue    # not a forward branch inside the loop
        end = int(m.group(1), 16)
        if end - a > cold[1] - cold[0] and any(
                a < x < end and "SHFL.BFLY" in u for x, u in body):
            cold = (a, end)
    hot = [t for a, t in body if not cold[0] < a < cold[1]]
    steps = sum(1 for t in hot if SHFL_UP.search(t)) / shfl_per_step
    if steps < 1:
        raise SassError(f"no sweep step in {kernel}'s SASS")
    return dict(steps_per_trip=steps, per_step=len(hot) / steps,
                counted_per_step=sum(1 for t in hot if count.search(t))
                / steps, trip=len(hot), cold_block=len(body) - len(hot))


def sass_step_loops(so: Path, kernel: str, shfl_per_step: int = 2,
                    count=FP) -> list[tuple[float, float, float]]:
    """(steps per trip, instructions per step, those matching ``count``
    per step) of every innermost loop of ``kernel`` that holds
    ``SHFL.UP``: the loop with the most steps per trip first, the others
    in the order of their addresses.  A sweep run in an unrolled loop
    between loops of single guarded steps (K7) shows the guarded steps'
    cost as the later entries."""
    ins = sass_function(so, kernel)
    loops = sass_loops(ins)
    out = []
    for lo, hi in loops:
        if any(lo <= a <= b <= hi and (a, b) != (lo, hi) for a, b in loops):
            continue    # holds another loop
        body = [t for a, t in ins if lo <= a <= hi]
        steps = sum(1 for t in body if SHFL_UP.search(t)) / shfl_per_step
        if steps >= 1:
            out.append((steps, len(body) / steps,
                        sum(1 for t in body if count.search(t)) / steps))
    if not out:
        raise SassError(f"no sweep step in {kernel}'s SASS")
    return sorted(out, key=lambda x: -x[0])


def sass_loop_size(so: Path, kernel: str, loop_by=WALK) -> int:
    """Instructions in the body of ``kernel``'s loop with the most
    instructions matching ``loop_by``: one trip of the pointer walk,
    branches both ways included (an upper count of one trip's
    instructions)."""
    ins = sass_function(so, kernel)
    loops = sass_loops(ins)
    if not loops:
        raise SassError(f"no loop in {kernel}'s SASS")
    lo, hi = max(loops, key=lambda r: (
        sum(1 for a, t in ins if r[0] <= a <= r[1] and loop_by.search(t)),
        r[0] - r[1]))
    return sum(1 for a, _ in ins if lo <= a <= hi)

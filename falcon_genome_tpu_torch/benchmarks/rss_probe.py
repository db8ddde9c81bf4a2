"""Host memory of the port's processes, split by source, step by step.

At each step the probe reads what the process holds on its host:

  * ``/proc/self/status``: ``VmRSS`` and its three parts ``RssAnon``
    (heap, stacks, anonymous maps), ``RssFile`` (pages of mapped files:
    the libraries of torch and CUDA, shared with the page cache) and
    ``RssShmem``, the high-water mark ``VmHWM`` and ``Threads``;
  * ``AnonHugePages`` of ``/proc/self/smaps_rollup``: anonymous memory
    in transparent huge pages;
  * glibc's ``mallinfo2()``: bytes the arenas took from the system
    (``arena``), in use in them (``uordblks``), free inside them
    (``fordblks``) and in chunks mapped on their own (``hblkhd``);
  * torch's caching host allocator (pinned blocks, active and cached) and
    ``torch.get_num_threads()``, once torch is imported.

The steps, in one process: (1) Python with numpy; (2) ``import torch``;
(3) ``torch.cuda.is_available()``; (4) ``device.resolve_device``; (5) the
first tensor on the device; (6) the kernel library loaded
(``ops._build.load``; on the card only); (7) the first launch of each of
K1-K4 at the main path's buckets (``--lanes`` lanes, 160 x 256 and
160 x 384); then, for each genome of ``--genomes``, the germline
rehearsal's four stages (``wgs_rehearsal.rehearse``) with a snapshot
before and after each stage and one every second inside it.  A stage's
row gives the ``RssAnon`` it added (its peak less its start) and the
``RssAnon`` it left behind (its end less its start).  The host's CPU
count, CPU affinity and transparent-huge-page mode are read once.

With ``--cli``, the rest of the arguments are one command of the CLI
(``falcon_genome_tpu_torch.cli``) run in this process; the probe reports
its exit code, its memory before, at its peak and after, and whether a
CUDA context came up (``torch.cuda.is_initialized()``).

With ``--watch``, the rest of the arguments (after ``--``) are any
command, run as a child process.  Every ``--period`` seconds the probe
sums ``VmRSS``, ``RssAnon``, ``RssFile`` and ``Threads`` over the child
and its descendants (from each one's ``/proc/<pid>/status``, or its
``smaps`` where the status lacks the split; ``RssFile`` is a plain sum,
so a library that two processes map counts twice).  It timestamps the child's
standard-error lines (passing them on), takes ``base_anon``, the summed
``RssAnon`` when the first log line appears (a line that starts with a
``YYYY-MM-DD HH:MM:SS`` timestamp: the stage has begun, its imports are
done), and reports the peaks, the split at the peak of ``VmRSS``,
``added_anon`` = peak ``RssAnon`` - ``base_anon`` (both None where the
child logs no such line), the wall time and the exit code, which it
exits with.

GB are 10^6 kB of ``/proc`` (1.024e9 bytes), the unit of the rehearsal
rows' ``peak_rss_gb``; ``mallinfo2`` and allocator bytes are converted to
it.

Usage:
    python -m falcon_genome_tpu_torch.benchmarks.rss_probe
        [--device cuda|cpu] [--genomes MB[,MB...]] [--work DIR]
        [--lanes N] [--out PATH]
    python -m falcon_genome_tpu_torch.benchmarks.rss_probe [--out PATH]
        --cli [--device cuda|cpu] COMMAND ARGS...
    python -m falcon_genome_tpu_torch.benchmarks.rss_probe --watch
        [--period S] [--out PATH] -- COMMAND ARGS...
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
DEFAULT_WORK = REPO / "build" / "rss_probe"
DEFAULT_OUT = Path(__file__).with_name("rss_probe.json")

STATUS_KEYS = ("VmRSS", "RssAnon", "RssFile", "RssShmem", "VmHWM",
               "Threads")
MALLINFO2_FIELDS = ("arena", "ordblks", "smblks", "hblks", "hblkhd",
                    "usmblks", "fsmblks", "uordblks", "fordblks",
                    "keepcost")
THP_PATH = "/sys/kernel/mm/transparent_hugepage/enabled"


def gb(kb: float) -> float:
    """kB of ``/proc`` to GB (10^6 kB)."""
    return round(kb / 1e6, 4)


def gb_of_bytes(n: float) -> float:
    return gb(n / 1024)


def proc_status(text: str | None = None) -> dict[str, int]:
    """The :data:`STATUS_KEYS` of ``/proc/self/status`` (or of ``text``):
    kB, and a count for ``Threads``; {} where the file cannot be read."""
    if text is None:
        try:
            with open("/proc/self/status") as f:
                text = f.read()
        except OSError:
            return {}
    out = {}
    for line in text.splitlines():
        key, _, rest = line.partition(":")
        if key in STATUS_KEYS and rest.split():
            out[key] = int(rest.split()[0])
    return out


def anon_huge_kb(path: str = "/proc/self/smaps_rollup") -> int | None:
    """``AnonHugePages`` (kB) of the process, or None where not readable."""
    try:
        with open(path) as f:
            for line in f:
                if line.startswith("AnonHugePages:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return None


def smaps_parts(text: str | None = None) -> dict[str, int] | None:
    """(kB) ``anon``: the ``Anonymous`` pages of every mapping, ``file``:
    the ``Rss`` of the mappings of a file (inode not 0), ``huge``: their
    ``AnonHugePages``, from ``/proc/self/smaps`` (or ``text``); None where
    not readable.  For kernels whose ``/proc/self/status`` lacks
    ``RssAnon`` and ``RssFile``."""
    if text is None:
        try:
            with open("/proc/self/smaps") as f:
                text = f.read()
        except OSError:
            return None
    out = {"anon": 0, "file": 0, "huge": 0}
    seen = False
    file_backed = False
    for line in text.splitlines():
        head = line.split(None, 5)
        if len(head) >= 5 and "-" in head[0] and ":" not in head[0]:
            file_backed = head[4] != "0"            # a mapping's header
            continue
        key, _, rest = line.partition(":")
        if key == "Rss" and file_backed:
            out["file"] += int(rest.split()[0])
        elif key == "Anonymous":
            out["anon"] += int(rest.split()[0])
            seen = True
        elif key == "AnonHugePages":
            out["huge"] += int(rest.split()[0])
    return out if seen else None


class _MallInfo2(ctypes.Structure):
    _fields_ = [(name, ctypes.c_size_t) for name in MALLINFO2_FIELDS]


_mallinfo2 = None


def mallinfo() -> dict[str, int] | None:
    """glibc's ``mallinfo2()`` over all arenas (bytes), or None where the
    C library has none (not glibc, or glibc before 2.33)."""
    global _mallinfo2
    if _mallinfo2 is None:
        fn = getattr(ctypes.CDLL(None), "mallinfo2", None)
        if fn is None:
            _mallinfo2 = False
        else:
            fn.restype = _MallInfo2
            fn.argtypes = []
            _mallinfo2 = fn
    if not _mallinfo2:
        return None
    m = _mallinfo2()
    return {name: int(getattr(m, name)) for name in MALLINFO2_FIELDS}


def pinned_bytes() -> int:
    """Bytes of torch's caching host allocator (pinned blocks, active and
    cached); 0 before torch is imported or a CUDA context is up."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return 0
    stats = torch.cuda.host_memory_stats()
    # "reserved" where the version names active + cached so, else
    # "allocated" (active + cached in the versions without "reserved")
    return int(stats.get("reserved_bytes.current",
                         stats.get("allocated_bytes.current", 0)))


def snapshot() -> dict:
    """What the process holds now (see the module's docstring)."""
    st = proc_status()
    if "RssAnon" in st:
        anon, file, huge = st["RssAnon"], st.get("RssFile"), anon_huge_kb()
    else:                       # a kernel without the split in its status
        parts = smaps_parts() or {}
        anon, file, huge = (parts.get(k) for k in ("anon", "file", "huge"))

    def kb(v):                  # a field the kernel does not give: None
        return None if v is None else gb(v)

    snap = {"rss_gb": kb(st.get("VmRSS")), "anon_gb": kb(anon),
            "file_gb": kb(file), "shmem_gb": kb(st.get("RssShmem")),
            "hwm_gb": kb(st.get("VmHWM")), "threads": st.get("Threads"),
            "huge_gb": kb(huge)}
    m = mallinfo()
    if m is not None:
        snap.update(malloc_arena_gb=gb_of_bytes(m["arena"]),
                    malloc_in_use_gb=gb_of_bytes(m["uordblks"]),
                    malloc_free_gb=gb_of_bytes(m["fordblks"]),
                    malloc_mmapped_gb=gb_of_bytes(m["hblkhd"]))
    snap["pinned_gb"] = gb_of_bytes(pinned_bytes())
    torch = sys.modules.get("torch")
    snap["torch_threads"] = (None if torch is None
                             else torch.get_num_threads())
    snap["cuda_initialized"] = bool(torch is not None
                                    and torch.cuda.is_initialized())
    return snap


def peak_split(samples: list[dict]) -> dict | None:
    """The sample of highest ``VmRSS`` split by source: live heap (in use
    in the arenas and mapped on its own), free inside the arenas, anonymous
    memory outside malloc (Python's object arenas, thread stacks, CUDA's
    own maps, pinned blocks), pinned host blocks, library pages and huge
    pages."""
    if not samples:
        return None
    s = max(samples, key=lambda x: x["rss_gb"])
    out = {"at_s": s.get("t_s"), "rss_gb": s["rss_gb"],
           "anon_gb": s["anon_gb"], "file_gb": s["file_gb"],
           "shmem_gb": s["shmem_gb"], "huge_gb": s["huge_gb"],
           "pinned_gb": s["pinned_gb"], "threads": s["threads"]}
    if "malloc_arena_gb" in s:
        out.update(
            live_heap_gb=round(s["malloc_in_use_gb"]
                               + s["malloc_mmapped_gb"], 4),
            arena_free_gb=s["malloc_free_gb"],
            anon_outside_malloc_gb=None if s["anon_gb"] is None else round(
                s["anon_gb"] - s["malloc_arena_gb"]
                - s["malloc_mmapped_gb"], 4))
    return out


def host_info() -> dict:
    """The host's CPUs, this process's CPU affinity, the transparent huge
    page mode and the allocator settings in the environment (read only)."""
    try:
        thp = Path(THP_PATH).read_text().strip()
    except OSError:
        thp = None
    libc = ctypes.CDLL(None)
    ver = getattr(libc, "gnu_get_libc_version", None)
    if ver is not None:
        ver.restype = ctypes.c_char_p
    return {"cpu_count": os.cpu_count(),
            "affinity": len(os.sched_getaffinity(0)),
            "transparent_hugepage": thp,
            "glibc": ver().decode() if ver is not None else None,
            "env": {k: v for k, v in os.environ.items()
                    if k.startswith(("MALLOC_", "CUDA_MODULE",
                                     "OMP_NUM", "PYTORCH_"))}}


def stage_row(genome_mb: float, stage: str, rec: dict) -> dict:
    """One stage of a rehearsal: its ``RssAnon`` at start, peak and end,
    what it added and left behind, what it held at its end, and the split
    at its peak sample."""
    start, end, samples = rec["start"], rec["end"], rec["samples"]
    snaps = [start, *samples, end]
    peak_threads = max(s["threads"] or 0 for s in snaps)
    if start["anon_gb"] is None:
        peak_anon = added = left = None
    else:
        peak_anon = max(s["anon_gb"] for s in snaps)
        added = round(peak_anon - start["anon_gb"], 4)
        left = round(end["anon_gb"] - start["anon_gb"], 4)
    return {"genome_mb": genome_mb, "stage": stage,
            "wall_s": rec["wall_s"],
            "rss_start_gb": start["rss_gb"], "rss_end_gb": end["rss_gb"],
            "peak_rss_gb": rec["peak_rss_gb"],
            "anon_start_gb": start["anon_gb"], "anon_peak_gb": peak_anon,
            "anon_end_gb": end["anon_gb"],
            "anon_added_gb": added, "anon_left_gb": left,
            "file_end_gb": end["file_gb"], "huge_end_gb": end["huge_gb"],
            "malloc_free_end_gb": end.get("malloc_free_gb"),
            "pinned_end_gb": end["pinned_gb"],
            "threads_peak": peak_threads,
            "peak_split": peak_split(samples)}


def say_step(rows: list[dict], name: str) -> dict:
    """Snapshot as step ``name``: appended to ``rows`` and printed."""
    s = {"step": name, **snapshot()}
    rows.append(s)
    print(f"rss_probe step {len(rows)} {name}: VmRSS {s['rss_gb']} GB, "
          f"RssAnon {s['anon_gb']} GB, RssFile {s['file_gb']} GB, "
          f"threads {s['threads']}, pinned {s['pinned_gb']} GB, "
          f"CUDA initialized {s['cuda_initialized']}", flush=True)
    return s


def first_launches(torch, device, lanes: int, step) -> None:
    """The first launch of K1, K2, K3 and K4 at the main path's buckets
    (SW 160 x 256, PairHMM 160 x 384), each followed by ``step``."""
    from ..ops import pairhmm as P
    from ..ops import smith_waterman as S
    R, W, H = 160, 256, 384
    rng = np.random.default_rng(0)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(device)

    read = put(rng.integers(0, 4, (lanes, R)), torch.int8)
    win = put(rng.integers(0, 4, (lanes, W)), torch.int8)
    rlen = put(np.full(lanes, R), torch.int32)
    wlen = put(np.full(lanes, W), torch.int32)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    params = S.SWParams()
    S.sw_score(read, rlen, win, wlen, params)
    sync()
    step("first K1 launch (sw_score)")
    ptrs = S.sw_pointers(read, rlen, win, wlen, params)
    sync()
    step("first K2 launch (sw_pointers)")
    S.sw_traceback(*ptrs, R + W)
    sync()
    step("first K3 launch (sw_traceback)")
    del ptrs
    P.pairhmm_sc(read.to(torch.uint8), put(rng.integers(10, 41, (lanes, R)),
                                           torch.uint8), rlen,
                 put(rng.integers(0, 4, (lanes, H)), torch.uint8),
                 put(np.full(lanes, H), torch.int32), 45, 45, 10)
    sync()
    step("first K4 launch (pairhmm_sc)")


def rehearsal_rows(genomes: list[float], work: Path, device) -> list[dict]:
    """The rehearsal's four stages on each genome, in this process."""
    from . import wgs_rehearsal as W
    rows = []
    for mb in genomes:
        W.G, W.N_PAIRS, W.N_SNPS = W.scale(mb)
        d = Path(work) / f"g{mb:g}"
        W.gen_dataset(d)
        series: dict = {}
        res = W.rehearse(d, set(W.STAGES.values()), device,
                         W.make_conf(d), {}, series=series)
        for stage in W.STAGES.values():
            row = stage_row(mb, stage, {**series[stage],
                                        "wall_s": res[stage]["wall_s"],
                                        "peak_rss_gb":
                                        res[stage]["peak_rss_gb"]})
            rows.append(row)
            print(f"rss_probe {mb:g} Mb {stage}: RssAnon "
                  f"{row['anon_start_gb']} -> peak {row['anon_peak_gb']} -> "
                  f"{row['anon_end_gb']} "
                  f"GB (added {row['anon_added_gb']}, left "
                  f"{row['anon_left_gb']}), VmRSS peak {row['peak_rss_gb']} "
                  f"GB, threads peak {row['threads_peak']}, free in arenas "
                  f"at end {row['malloc_free_end_gb']} GB", flush=True)
    return rows


def run_cli(cli_argv: list[str]) -> dict:
    """One CLI command in this process: exit code, memory before, peak and
    after, and whether a CUDA context came up."""
    before = snapshot()
    from .. import cli
    from .wgs_rehearsal import RssSampler
    imported = snapshot()
    sampler = RssSampler()
    t0 = time.perf_counter()
    rc = cli.main(cli_argv)
    wall = time.perf_counter() - t0
    sampler.stop()
    after = snapshot()
    return {"argv": cli_argv, "rc": rc, "wall_s": round(wall, 1),
            "before": before, "imported": imported,
            "peak_rss_gb": round(sampler.peak, 4),
            "peak_rss_anon_gb": (None if sampler.peak_anon is None
                                 else round(sampler.peak_anon, 4)),
            "after": after,
            "cuda_initialized": after["cuda_initialized"]}


def reading_cost(n: int = 5) -> dict[str, float]:
    """Milliseconds of one reading, the median of ``n``: the status line
    the rehearsal's sampler reads four times a second, ``smaps`` (read
    every 5 s where the status lacks the split) and a full snapshot (one
    a second with ``--series``)."""
    def ms(fn):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return round(sorted(times)[n // 2], 3)
    return {"proc_status": ms(proc_status), "smaps": ms(smaps_parts),
            "snapshot": ms(snapshot)}


# ---------------------------------------------------------------------------
# --watch: any command as a child process, sampled from outside
# ---------------------------------------------------------------------------

# a log record's start (the logging format's asctime): the stage has begun
LOG_LINE = re.compile(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d")
# samples and standard-error lines kept in a watch's document (the peaks
# use every sample)
SERIES_KEPT, LOG_KEPT = 60, 10


def descendants(pid: int) -> list[int]:
    """``pid`` and every live process below it, by each process's parent
    in ``/proc/<p>/stat``."""
    children: dict[int, list[int]] = {}
    for entry in os.scandir("/proc"):
        if not entry.name.isdigit():
            continue
        try:
            with open(f"/proc/{entry.name}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        ppid = int(stat.rpartition(")")[2].split()[1])
        children.setdefault(ppid, []).append(int(entry.name))
    out, todo = [], [pid]
    while todo:
        p = todo.pop()
        out.append(p)
        todo.extend(children.get(p, ()))
    return out


def process_memory(pid: int) -> dict | None:
    """``VmRSS``, ``RssAnon``, ``RssFile`` (kB) and ``Threads`` of one
    process, the split from its ``smaps`` where its status lacks it (then
    ``"smaps": True``; the split None where neither gives it); None once
    the process is gone or holds no memory (a zombie)."""
    try:
        with open(f"/proc/{pid}/status") as f:
            st = proc_status(f.read())
    except OSError:
        return None
    if "VmRSS" not in st:
        return None
    if "RssAnon" not in st:
        try:
            with open(f"/proc/{pid}/smaps") as f:
                parts = smaps_parts(f.read())
        except OSError:
            parts = None
        st["RssAnon"] = None if parts is None else parts["anon"]
        st["RssFile"] = None if parts is None else parts["file"]
        st["smaps"] = True
    return st


def tree_sample(pid: int, t0: float) -> dict | None:
    """The process ``pid`` and its descendants, summed now: GB of
    ``VmRSS``, ``RssAnon`` and ``RssFile`` (None where a process gives no
    split), threads and processes; None once ``pid`` is gone."""
    procs = [m for m in map(process_memory, descendants(pid)) if m]
    if not procs:
        return None
    split = all(m["RssAnon"] is not None for m in procs)

    def total(key):
        return gb(sum(m[key] for m in procs)) if split else None

    return {"t_s": round(time.perf_counter() - t0, 3),
            "rss_gb": gb(sum(m["VmRSS"] for m in procs)),
            "anon_gb": total("RssAnon"), "file_gb": total("RssFile"),
            "threads": sum(m.get("Threads", 0) for m in procs),
            "processes": len(procs),
            "split_from": (None if not split else "smaps"
                           if any(m.get("smaps") for m in procs)
                           else "status")}


def thin(items: list, n: int) -> list:
    """At most ``n`` of ``items``, evenly spaced, the last one kept."""
    if len(items) <= n:
        return list(items)
    step = (len(items) - 1) / (n - 1)
    return [items[round(i * step)] for i in range(n)]


def watch(cmd: list[str], period: float = 0.5) -> dict:
    """Run ``cmd`` as a child process and sample it and its descendants
    every ``period`` seconds (see the module's docstring); its standard
    error is passed on, each line timestamped."""
    t0 = time.perf_counter()
    child = subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True,
                             errors="replace")
    lines: list[list] = []
    base: dict = {}

    def read_stderr():
        for line in child.stderr:
            t = round(time.perf_counter() - t0, 3)
            sys.stderr.write(line)
            sys.stderr.flush()
            lines.append([t, line.rstrip("\n")])
            if "at_s" not in base and LOG_LINE.match(line):
                base.update(at_s=t, line=line.rstrip("\n"),
                            sample=tree_sample(child.pid, t0))

    reader = threading.Thread(target=read_stderr, daemon=True)
    reader.start()
    samples: list[dict] = []
    try:
        while True:
            s = tree_sample(child.pid, t0)
            if s is not None:
                samples.append(s)
            try:
                child.wait(timeout=period)
                break
            except subprocess.TimeoutExpired:
                pass
    finally:
        if child.poll() is None:            # interrupted: stop the child
            child.kill()
            child.wait()
    reader.join()
    wall = time.perf_counter() - t0
    rc = child.returncode

    if "at_s" in base and base["sample"] is None:   # the line, no sample
        after = [s for s in samples if s["t_s"] >= base["at_s"]]
        base["sample"] = after[0] if after else None
    # no log line: no base, and no added_anon
    base_sample = base.get("sample")
    base_anon = None if base_sample is None else base_sample["anon_gb"]
    known = [s["anon_gb"] for s in samples if s["anon_gb"] is not None]
    peak_anon = max(known) if known else None
    peak = max(samples, key=lambda s: s["rss_gb"]) if samples else None

    def peak_of(key):
        vals = [s[key] for s in samples if s[key] is not None]
        return max(vals) if vals else None

    return {"argv": cmd, "rc": rc, "wall_s": round(wall, 2),
            "period_s": period, "samples": len(samples),
            "peak_rss_gb": peak_of("rss_gb"), "peak_anon_gb": peak_anon,
            "peak_file_gb": peak_of("file_gb"),
            "peak_threads": peak_of("threads"),
            "peak_processes": peak_of("processes"),
            "split_at_peak": peak,
            "base_at_s": base.get("at_s"), "base_line": base.get("line"),
            "base_anon_gb": base_anon,
            "added_anon_gb": (None if None in (peak_anon, base_anon)
                              else round(peak_anon - base_anon, 4)),
            "stderr_lines": len(lines),
            "stderr_head": lines[:LOG_KEPT],
            "stderr_tail": lines[-LOG_KEPT:] if len(lines) > LOG_KEPT
            else [],
            "series": thin(samples, SERIES_KEPT)}


def append_run(path: str | None, doc: dict) -> None:
    """Append a watch's document to the ``runs`` of the JSON at ``path``
    (made where it does not exist), so runs in turn collect in one file."""
    if not path:
        return
    p = Path(path)
    runs = json.loads(p.read_text())["runs"] if p.exists() else []
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps({"host": host_info(),
                             "runs": [*runs, doc]}, indent=1))


def write(path: str | None, doc: dict) -> None:
    if path:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(json.dumps(doc, indent=1))


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--watch" in (argv[:argv.index("--")] if "--" in argv else argv):
        return main_watch(argv)
    cli_argv = None
    if "--cli" in argv:
        i = argv.index("--cli")
        argv, cli_argv = argv[:i], argv[i + 1:]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--genomes", default="0.6,16",
                    help="genomes (Mb) of the rehearsal, comma-separated; "
                         "empty for none")
    ap.add_argument("--work", default=str(DEFAULT_WORK))
    ap.add_argument("--lanes", type=int, default=8192,
                    help="lanes / pairs of the first K1-K4 launches")
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="results JSON (empty: print only)")
    args = ap.parse_args(argv)
    host = host_info()
    if cli_argv is not None:
        doc = {"host": host, "cli": run_cli(cli_argv)}
        print(json.dumps(doc["cli"]))
        write(args.out, doc)
        return 0
    print(f"rss_probe host: {json.dumps(host)}", flush=True)
    steps: list[dict] = []
    say_step(steps, "python + numpy")
    import torch
    say_step(steps, "import torch")
    from ..device import resolve_device
    if torch.device(args.device).type == "cuda":
        torch.cuda.is_available()
        say_step(steps, "torch.cuda.is_available()")
    device = resolve_device(args.device)
    say_step(steps, f"resolve_device({args.device!r})")
    torch.zeros(1, device=device).sum().item()
    say_step(steps, "first tensor on the device")
    if device.type == "cuda":
        from ..ops import _build
        _build.load()
        say_step(steps, "kernel library loaded (ops._build.load)")
    first_launches(torch, device, args.lanes,
                   lambda name: say_step(steps, name))
    from .wgs_rehearsal import card_label
    doc = {"host": host, "card": card_label(device),
           "torch": torch.__version__, "steps": steps,
           "cost_ms": reading_cost()}
    print(f"rss_probe cost of one reading: {json.dumps(doc['cost_ms'])} ms",
          flush=True)
    write(args.out, doc)
    genomes = [float(g) for g in args.genomes.split(",") if g.strip()]
    doc["stages"] = rehearsal_rows(genomes, Path(args.work), device)
    write(args.out, doc)
    print(json.dumps({"rss_probe": {"card": doc["card"],
                                    "steps": len(steps),
                                    "stages": len(doc["stages"])}}))
    return 0


def main_watch(argv: list[str]) -> int:
    """``--watch [--period S] [--out PATH] -- COMMAND ...``: the command's
    memory from outside; exits with its exit code."""
    if "--" not in argv:
        raise SystemExit("rss_probe --watch: the command follows --")
    i = argv.index("--")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--watch", action="store_true")
    ap.add_argument("--period", type=float, default=0.5,
                    help="seconds between samples")
    ap.add_argument("--out", default="",
                    help="JSON whose runs this run is appended to")
    args = ap.parse_args(argv[:i])
    cmd = argv[i + 1:]
    if not cmd:
        raise SystemExit("rss_probe --watch: no command after --")
    doc = watch(cmd, args.period)
    append_run(args.out, doc)
    print(json.dumps({k: v for k, v in doc.items()
                      if k not in ("series", "stderr_head", "stderr_tail")}),
          flush=True)
    rc = doc["rc"]
    return rc if rc >= 0 else 128 - rc      # killed by signal -rc


if __name__ == "__main__":
    sys.exit(main())

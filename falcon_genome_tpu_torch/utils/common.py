"""Filesystem helpers and deterministic shard naming.

Re-expresses the reference's common utils (src/common.cpp,
include/fcs-genome/common.h): input/output validation with overwrite policy
(common.cpp:60-114), recursive regex dir listing (common.cpp:116-162) and the
deterministic shard filename scheme ``part-%06d.<ext>`` (common.h:232-245,
common.cpp:226-233).

Deterministic artifact naming is load-bearing: it is what makes every pipeline
stage individually re-runnable (the reference's checkpoint/resume story,
SURVEY.md §5) — the TPU build keeps the exact same scheme so shard outputs are
addressable without a manifest.
"""
from __future__ import annotations

import logging
import os
import re
import shutil
import sys
from pathlib import Path
from typing import Iterable

from .errors import FileNotFound, FilesNotFound, SilentExit

log = logging.getLogger("falcon_genome_tpu")


# ---------------------------------------------------------------------------
# path validation (ref: common.cpp:60-114)
# ---------------------------------------------------------------------------

def get_absolute_path(path: str | os.PathLike) -> str:
    return str(Path(path).absolute())


def check_input(path: str | os.PathLike, required: bool = True) -> str:
    """Validate that an input file exists; returns its absolute path.

    ``required=False`` mirrors the reference's tool-path probing
    (config.cpp:197-207): missing is tolerated, returns the path unchanged.
    """
    p = Path(path)
    if not p.exists():
        if required:
            raise FileNotFound(str(path))
        return str(path)
    return str(p.absolute())


def check_vcf_index(vcf_path: str, strict: bool = True) -> str:
    """Known-sites VCF index freshness check (ref config.cpp:776-824).

    ``.vcf`` expects ``.idx``, ``.gz`` expects ``.tbi`` (other extensions
    error); a missing index raises FileNotFound; an index older than the
    VCF gets its mtime touched to now (the reference does this so GATK
    doesn't stall re-indexing).  ``strict=False`` downgrades the
    missing-index error to a warning — this engine's plain-VCF reader
    does not need a tribble ``.idx`` to run.
    """
    ext = Path(vcf_path).suffix
    if ext == ".vcf":
        idx = str(vcf_path) + ".idx"
    elif ext == ".gz":
        idx = str(vcf_path) + ".tbi"
    else:
        log.error("Unrecognized index extension for %s", vcf_path)
        raise SilentExit()
    if not Path(idx).exists():
        if strict:
            raise FileNotFound(f"VCF index file {idx} does not exist")
        log.warning("VCF index %s missing (tolerated: native VCF reader)",
                    idx)
        return str(vcf_path)
    if os.path.getmtime(vcf_path) > os.path.getmtime(idx):
        log.info("VCF index outdated, touching: %s", idx)
        os.utime(idx, None)
    return str(vcf_path)


def check_output(path: str | os.PathLike, force: bool = False,
                 require_write: bool = True) -> str:
    """Validate an output path; delete existing output if ``force``.

    Mirrors common.cpp:75-114: if the output exists and ``force`` is unset the
    reference interactively prompts; non-interactive contexts fail.  Here we
    prompt only when attached to a TTY, otherwise raise.
    """
    p = Path(path)
    if p.exists():
        if not force:
            if sys.stdin.isatty() and sys.stdout.isatty():
                ans = input(f"[falcon-genome-tpu] {p} already exists, overwrite? (yes/no) ")
                if ans.strip().lower() not in ("y", "yes"):
                    raise SilentExit(f"will not overwrite {p}")
            else:
                raise SilentExit(
                    f"output {p} already exists; pass --force/-f to overwrite")
        remove_path(p)
    parent = p.parent if str(p.parent) else Path(".")
    if require_write and parent.exists() and not os.access(parent, os.W_OK):
        raise SilentExit(f"output dir {parent} is not writable")
    parent.mkdir(parents=True, exist_ok=True)
    return str(p.absolute())


def check_dir(path: str | os.PathLike) -> str:
    p = Path(path)
    if not p.is_dir():
        raise FileNotFound(str(path))
    return str(p.absolute())


def create_dir(path: str | os.PathLike) -> str:
    Path(path).mkdir(parents=True, exist_ok=True)
    return str(Path(path).absolute())


def remove_path(path: str | os.PathLike) -> None:
    p = Path(path)
    if p.is_dir() and not p.is_symlink():
        shutil.rmtree(p, ignore_errors=True)
    elif p.exists() or p.is_symlink():
        p.unlink()


# ---------------------------------------------------------------------------
# shard listing & naming (ref: common.cpp:116-162, 226-233; common.h:232-245)
# ---------------------------------------------------------------------------

def get_input_list(path: str | os.PathLike, pattern: str,
                   required: bool = True) -> list[str]:
    """List files in a dir matching a regex, sorted; or the file itself.

    Mirrors common.cpp:116-162 (``get_input_list``): if ``path`` is a file it
    must match ``pattern``; if a dir, all *regular* entries matching the regex
    are returned sorted.  The regex matches the basename, full-match semantics
    (boost::regex_match).
    """
    p = Path(path)
    rx = re.compile(pattern)
    if p.is_file():
        if rx.fullmatch(p.name):
            return [str(p.absolute())]
        raise FilesNotFound(f"{path} (pattern {pattern})")
    if p.is_dir():
        out = sorted(
            str(f.absolute()) for f in p.iterdir()
            if f.is_file() and rx.fullmatch(f.name)
        )
        if not out and required:
            raise FilesNotFound(f"{path}/{pattern}")
        return out
    if required:
        raise FileNotFound(str(path))
    return []


def get_contig_fname(base_path: str | os.PathLike, contig: int,
                     ext: str = "bam", prefix: str = "part-") -> str:
    """Deterministic shard filename: ``<dir>/<prefix>%06d.<ext>``
    (ref: common.h:232-245)."""
    return f"{base_path}/{prefix}{contig:06d}.{ext}"


def get_bucket_fname(dir_: str | os.PathLike, bucket: int,
                     stem: str = "part", ext: str = ".bam") -> str:
    """Bucket filename ``<dir>/<stem>-%06d<ext>`` (ref: common.cpp:226-233)."""
    return f"{dir_}/{stem}-{bucket:06d}{ext}"


def get_basename(path: str | os.PathLike) -> str:
    return Path(path).name


def get_basename_wo_ext(path: str | os.PathLike) -> str:
    name = Path(path).name
    # strip compound genomics extensions the way operators expect
    for ext in (".fastq.gz", ".fq.gz", ".vcf.gz", ".g.vcf.gz", ".g.vcf"):
        if name.endswith(ext):
            return name[: -len(ext)]
    return Path(name).stem


def get_fname_by_ext(fname: str | os.PathLike, ext: str) -> str:
    """Replace a file's extension (ref: common.cpp:216-224)."""
    p = Path(fname)
    stem = p.stem
    if str(p.parent) not in ("", "."):
        return f"{p.parent}/{stem}.{ext}"
    return f"{stem}.{ext}"


def get_files_by_ext(dir_: str | os.PathLike, ext: str) -> list[str]:
    return sorted(str(p) for p in Path(dir_).iterdir()
                  if p.is_file() and p.suffix == f".{ext.lstrip('.')}")


def rss_suffix() -> str:
    """' (rss X.X GB, peak Y.Y GB)' from /proc/self/status — per-stage
    memory telemetry for WGS-scale runs; empty off Linux."""
    try:
        cur = peak = 0
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    cur = int(line.split()[1])
                elif line.startswith("VmHWM"):
                    peak = int(line.split()[1])
        return f" (rss {cur / 1e6:.1f} GB, peak {peak / 1e6:.1f} GB)"
    except OSError:
        return ""


def iter_chunks(seq: Iterable, n: int):
    """Yield lists of at most n items."""
    buf = []
    for item in seq:
        buf.append(item)
        if len(buf) == n:
            yield buf
            buf = []
    if buf:
        yield buf


def rss_suffix() -> str:
    """' (rss X.X GB, peak Y.Y GB)' from /proc/self/status — per-stage
    memory telemetry for WGS-scale runs; empty off Linux."""
    try:
        cur = peak = 0
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    cur = int(line.split()[1])
                elif line.startswith("VmHWM"):
                    peak = int(line.split()[1])
        return f" (rss {cur / 1e6:.1f} GB, peak {peak / 1e6:.1f} GB)"
    except OSError:
        return ""

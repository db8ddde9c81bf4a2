"""Multi-sample batch input: sample sheets.

Mirrors the reference's SampleSheet (SURVEY.md §2 row 9,
src/SampleSheet.cpp): either a CSV with header
``#sample_id,fastq1,fastq2,rg,platform_id,library_id`` (:22-121) or a
directory scan pairing ``*1.fastq.gz``/``*2.fastq.gz`` files with
auto-generated read-group/library tags (:123-211).
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path

from .utils.errors import FileNotFound, InvalidParam

HEADER_FIELDS = ["sample_id", "fastq1", "fastq2", "rg", "platform_id",
                 "library_id"]


@dataclasses.dataclass
class SampleDetails:
    fastq1: str
    fastq2: str
    read_group: str
    platform_id: str
    library_id: str


SampleSheetMap = dict[str, list[SampleDetails]]


def load_sample_sheet(path: str | Path) -> SampleSheetMap:
    p = Path(path)
    if p.is_dir():
        return _scan_dir(p)
    if p.is_file():
        return _parse_csv(p)
    raise FileNotFound(str(path))


def _parse_csv(p: Path) -> SampleSheetMap:
    lines = [ln for ln in p.read_text().splitlines() if ln.strip()]
    if not lines:
        raise InvalidParam(f"empty sample sheet {p}")
    header = lines[0]
    if not header.startswith("#"):
        raise InvalidParam(
            f"sample sheet {p} missing '#'-prefixed header line")
    cols = [c.strip() for c in header.lstrip("#").split(",")]
    missing = [f for f in HEADER_FIELDS if f not in cols]
    if missing:
        raise InvalidParam(f"sample sheet {p} missing columns: {missing}")
    idx = {c: i for i, c in enumerate(cols)}
    out: SampleSheetMap = {}
    for ln in lines[1:]:
        if ln.startswith("#"):
            continue
        f = [c.strip() for c in ln.split(",")]
        if len(f) < len(cols):
            raise InvalidParam(f"sample sheet {p}: short row {ln!r}")
        sid = f[idx["sample_id"]]
        out.setdefault(sid, []).append(SampleDetails(
            fastq1=f[idx["fastq1"]], fastq2=f[idx["fastq2"]],
            read_group=f[idx["rg"]], platform_id=f[idx["platform_id"]],
            library_id=f[idx["library_id"]]))
    return out


_R1 = re.compile(r"(.*?)_?(R?1)\.(fastq|fq)(\.gz)?$")


def _scan_dir(p: Path) -> SampleSheetMap:
    out: SampleSheetMap = {}
    for f in sorted(p.iterdir()):
        m = _R1.match(f.name)
        if not m:
            continue
        stem, r1tag = m.group(1), m.group(2)
        mate_name = f.name.replace(r1tag + ".", r1tag[:-1] + "2.", 1)
        mate = f.parent / mate_name
        if not mate.exists():
            continue
        sid = stem.rstrip("_")
        n = len(out.get(sid, []))
        out.setdefault(sid, []).append(SampleDetails(
            fastq1=str(f), fastq2=str(mate),
            read_group=f"{sid}-rg{n}", platform_id="illumina",
            library_id=f"{sid}-lib"))
    if not out:
        raise InvalidParam(f"no FASTQ pairs found in {p}")
    return out

"""Genome interval model and the three shard splitters.

The interval splitters are the reference's core data-parallel sharding
primitive (SURVEY.md §2 row 3, P1): the genome is partitioned into
``gatk.ncontigs`` shards, one caller worker per shard.  The TPU build keeps
the identical shard *boundaries* (outputs depend on them) but the shards map
to mesh regions rather than processes.

* :func:`split_equal_bp`      — equal-base-pair partition of the ``.dict``
  contig table, splitting chromosomes mid-sequence when needed, skipping
  pseudo-chromosomes past the first 25 (ref ``init_contig_intv``,
  src/config.cpp:393-512).
* :func:`split_ref_round_up`  — per-chromosome fixed-width chunks, width
  ``roundUp(max_chr_len/ncontigs, ncontigs)``, distributed round-robin-block
  into shard files (ref ``split_ref_by_nprocs``, src/config.cpp:525-689;
  used by depth).  The reference emits overlapping chunk bounds and patches
  the overlap with a "+1 to the first start of each file" fix-up
  (config.cpp:657-672); we generate non-overlapping chunks directly, which
  yields the same covered positions.
* :func:`split_interval_file` — split a user BED/gene list into ncontigs
  equal line chunks (ref ``split_by_nprocs``, src/config.cpp:708-774).

Conventions: ``Interval`` is 1-based inclusive (GATK ``.list`` style,
``chr:start-end``); BED I/O converts to/from 0-based half-open.
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path

from ..utils.errors import InvalidParam
from .fasta import ReferenceDict

MAX_PRIMARY_CONTIGS = 25  # ref config.cpp:437-439: skip pseudo-chrs past 25


@dataclasses.dataclass(frozen=True, order=True)
class Interval:
    """1-based inclusive genomic interval."""
    contig: str
    start: int
    end: int

    def __post_init__(self):
        if self.start < 1 or self.end < self.start:
            raise InvalidParam(f"bad interval {self.contig}:{self.start}-{self.end}")

    def __str__(self) -> str:
        return f"{self.contig}:{self.start}-{self.end}"

    def __len__(self) -> int:
        return self.end - self.start + 1

    def overlaps(self, other: "Interval") -> bool:
        return (self.contig == other.contig and
                self.start <= other.end and other.start <= self.end)

    def intersect(self, other: "Interval") -> "Interval | None":
        if not self.overlaps(other):
            return None
        return Interval(self.contig, max(self.start, other.start),
                        min(self.end, other.end))


def parse_interval(s: str) -> Interval:
    """Parse ``chr``, ``chr:start-end``, or ``chr:pos``."""
    m = re.fullmatch(r"([^:]+):(\d+)-(\d+)", s)
    if m:
        return Interval(m.group(1), int(m.group(2)), int(m.group(3)))
    m = re.fullmatch(r"([^:]+):(\d+)", s)
    if m:
        pos = int(m.group(2))
        return Interval(m.group(1), pos, pos)
    if ":" not in s and s:
        # whole-contig intervals need the dict to resolve length; caller
        # should pre-expand. Reject here to avoid silent misuse.
        raise InvalidParam(f"whole-contig interval {s!r} needs explicit bounds")
    raise InvalidParam(f"cannot parse interval {s!r}")


def read_interval_list(path: str | Path,
                       rdict: ReferenceDict | None = None) -> list[Interval]:
    """Read a GATK-style ``.list`` (one interval per line) or ``.bed``."""
    p = Path(path)
    is_bed = p.suffix == ".bed"
    out: list[Interval] = []
    for line in p.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith(("#", "@", "track")):
            continue
        if is_bed:
            fields = line.split("\t")
            out.append(Interval(fields[0], int(fields[1]) + 1, int(fields[2])))
        elif ":" not in line and rdict is not None:
            out.append(Interval(line, 1, rdict.by_name[line].length))
        else:
            out.append(parse_interval(line))
    return out


def write_interval_list(path: str | Path, intervals: list[Interval]) -> str:
    is_bed = Path(path).suffix == ".bed"
    with open(path, "w") as f:
        for iv in intervals:
            if is_bed:
                f.write(f"{iv.contig}\t{iv.start - 1}\t{iv.end}\n")
            else:
                f.write(f"{iv.contig}:{iv.start}-{iv.end}\n")
    return str(path)


# ---------------------------------------------------------------------------
# splitter (a): equal-bp partition (ref init_contig_intv, config.cpp:393-512)
# ---------------------------------------------------------------------------

def _primary_contigs(rdict: ReferenceDict, skip_pseudo: bool):
    contigs = list(rdict)
    return contigs[:MAX_PRIMARY_CONTIGS] if skip_pseudo else contigs


def split_equal_bp(rdict: ReferenceDict, ncontigs: int,
                   skip_pseudo_chr: bool = True) -> list[list[Interval]]:
    """Partition the genome into ``ncontigs`` equal-bp interval shards.

    Exact semantics of config.cpp:469-508: shard capacity is
    ``ceil(total/ncontigs)`` positions; chromosomes are split mid-sequence
    when they overflow the current shard's remaining capacity.
    """
    contigs = _primary_contigs(rdict, skip_pseudo_chr)
    total = sum(c.length for c in contigs)
    if ncontigs < 1:
        raise InvalidParam(f"ncontigs must be >= 1, got {ncontigs}")
    cap = (total + ncontigs - 1) // ncontigs

    shards: list[list[Interval]] = [[] for _ in range(ncontigs)]
    idx = 0
    remain = cap
    for c in contigs:
        lbound = 1
        npos = c.length
        if remain == 0:
            # exact-fill boundary: the reference emits a degenerate "chr:1-0"
            # line here (config.cpp:490-501 with remain_npos==0); we advance
            # to the next shard instead — identical coverage, no bogus line.
            idx += 1
            remain = cap
        while npos > remain:
            ubound = remain + lbound - 1
            shards[idx].append(Interval(c.name, lbound, ubound))
            lbound = ubound + 1
            npos -= remain
            remain = cap
            idx += 1
        if npos > 0:
            shards[idx].append(Interval(c.name, lbound, c.length))
            remain -= npos
    return shards


# ---------------------------------------------------------------------------
# splitter (b): per-chromosome round-up chunks (ref split_ref_by_nprocs)
# ---------------------------------------------------------------------------

def round_up(n: int, multiple: int) -> int:
    """ref config.cpp:514-522."""
    if multiple == 0:
        return n
    r = abs(n) % multiple
    if r == 0:
        return n
    return n + multiple - r if n >= 0 else -(abs(n) - r)


def split_ref_round_up(rdict: ReferenceDict, ncontigs: int,
                       skip_pseudo_chr: bool = True) -> list[list[Interval]]:
    """Per-chromosome fixed-width chunking distributed into shard files.

    Chunk width = ``round_up(max_chr_len // ncontigs, ncontigs)``
    (config.cpp:602-603); chunks never span chromosomes; chunk lists are
    dealt into shards in contiguous blocks of
    ``round(num_chunks / ncontigs)`` (config.cpp:645-684).
    """
    contigs = _primary_contigs(rdict, skip_pseudo_chr)
    if not contigs:
        return [[] for _ in range(ncontigs)]
    max_len = max(c.length for c in contigs)
    width = round_up(max_len // ncontigs, ncontigs)
    if width == 0:
        width = max_len or 1

    chunks: list[Interval] = []
    for c in contigs:
        start = 1
        while start <= c.length:
            end = min(start + width - 1, c.length)
            chunks.append(Interval(c.name, start, end))
            start = end + 1

    per_file = max(1, round(len(chunks) / ncontigs))
    shards: list[list[Interval]] = [[] for _ in range(ncontigs)]
    idx = 0
    count = 0
    for ch in chunks:
        shards[idx].append(ch)
        count += 1
        if count == per_file and idx < ncontigs - 1:
            idx += 1
            count = 0
    return shards


# ---------------------------------------------------------------------------
# splitter (c): split a user interval file (ref split_by_nprocs)
# ---------------------------------------------------------------------------

def split_interval_file(path: str | Path, ncontigs: int,
                        rdict: ReferenceDict | None = None
                        ) -> list[list[Interval]]:
    """Split a user BED/list into ncontigs chunks of equal line count
    (config.cpp:708-759: chunk = round_up(n // ncontigs, ncontigs) lines).

    Deviation from the reference: when n is not a multiple of the chunk
    size, config.cpp:752-754 silently drops the tail lines past
    ``ncontigs * chunk``; here the last shard always extends through the end
    so every input interval is covered.
    """
    ivs = read_interval_list(path, rdict)
    n = len(ivs)
    chunk = round_up(n // ncontigs, ncontigs) if n >= ncontigs else 1
    shards: list[list[Interval]] = []
    for i in range(ncontigs):
        start = i * chunk
        end = min(start + chunk, n) if i < ncontigs - 1 else n
        shards.append(ivs[start:end])
    return shards


# ---------------------------------------------------------------------------
# composition (ref -L a -L b -isr INTERSECTION, HTCWorker.cpp:64-68)
# ---------------------------------------------------------------------------

def intersect_intervals(a: list[Interval], b: list[Interval]) -> list[Interval]:
    """Intersection of two interval lists (both sorted or not)."""
    a = sorted(a)
    b = sorted(b)
    out: list[Interval] = []
    i = j = 0
    while i < len(a) and j < len(b):
        x, y = a[i], b[j]
        if x.contig == y.contig:
            iv = x.intersect(y)
            if iv:
                out.append(iv)
            if x.end <= y.end:
                i += 1
            else:
                j += 1
        elif (x.contig, x.start) < (y.contig, y.start):
            i += 1
        else:
            j += 1
    return out

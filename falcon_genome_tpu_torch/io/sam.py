"""SAM data model: flags, CIGAR, records, headers.

The reference delegates all SAM/BAM handling to external tools (bwa-flow
writes, sambamba sorts/merges — SURVEY.md §2 rows 11/19); the TPU build owns
the format.  Alignment results live on device as flat arrays; this module is
the boundary where they become records.
"""
from __future__ import annotations

import dataclasses
import re

from ..utils.errors import InvalidParam

# --- flags (SAM spec) -------------------------------------------------------
FLAG_PAIRED = 0x1
FLAG_PROPER_PAIR = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80
FLAG_SECONDARY = 0x100
FLAG_QCFAIL = 0x200
FLAG_DUP = 0x400
FLAG_SUPPLEMENTARY = 0x800

# --- CIGAR ------------------------------------------------------------------
CIGAR_OPS = "MIDNSHP=X"
CIGAR_M, CIGAR_I, CIGAR_D, CIGAR_N, CIGAR_S, CIGAR_H, CIGAR_P, CIGAR_EQ, \
    CIGAR_X = range(9)
_CONSUMES_QUERY = {CIGAR_M, CIGAR_I, CIGAR_S, CIGAR_EQ, CIGAR_X}
_CONSUMES_REF = {CIGAR_M, CIGAR_D, CIGAR_N, CIGAR_EQ, CIGAR_X}

Cigar = list[tuple[int, int]]  # [(op, length)]


def cigar_to_str(cigar: Cigar) -> str:
    if not cigar:
        return "*"
    return "".join(f"{n}{CIGAR_OPS[op]}" for op, n in cigar)


def cigar_from_str(s: str) -> Cigar:
    if s == "*" or not s:
        return []
    out = []
    for m in re.finditer(r"(\d+)([MIDNSHP=X])", s):
        out.append((CIGAR_OPS.index(m.group(2)), int(m.group(1))))
    if sum(n for _, n in out) == 0 or cigar_to_str(out) != s:
        raise InvalidParam(f"bad CIGAR {s!r}")
    return out


def cigar_query_len(cigar: Cigar) -> int:
    return sum(n for op, n in cigar if op in _CONSUMES_QUERY)


def cigar_ref_len(cigar: Cigar) -> int:
    return sum(n for op, n in cigar if op in _CONSUMES_REF)


# --- records ----------------------------------------------------------------

class SamRecord:
    """One alignment record. ``pos`` is 0-based (BAM convention); rendered
    1-based in SAM text.

    Slotted (not a dataclass): the BAM reader materializes millions of
    these, and tag parsing is deferred — ``_raw_tags`` holds the record's
    raw BAM tag bytes until ``tags`` is first touched (most stages never
    touch it, and the BAM writer re-emits raw bytes unchanged)."""

    __slots__ = ("qname", "flag", "tid", "pos", "mapq", "cigar", "mtid",
                 "mpos", "tlen", "seq", "qual", "_tags", "_raw_tags")

    def __init__(self, qname: str, flag: int = FLAG_UNMAPPED, tid: int = -1,
                 pos: int = -1, mapq: int = 0, cigar: Cigar | None = None,
                 mtid: int = -1, mpos: int = -1, tlen: int = 0,
                 seq: str = "*", qual: str = "*",
                 tags: dict[str, tuple[str, object]] | None = None):
        self.qname = qname
        self.flag = flag
        self.tid = tid
        self.pos = pos
        self.mapq = mapq
        self.cigar = cigar if cigar is not None else []
        self.mtid = mtid
        self.mpos = mpos
        self.tlen = tlen
        self.seq = seq
        self.qual = qual
        self._tags = tags if tags is not None else {}
        self._raw_tags = None

    @property
    def tags(self) -> dict[str, tuple[str, object]]:
        if self._raw_tags is not None:
            from .bam import _decode_tags
            raw, self._raw_tags = self._raw_tags, None
            decoded = _decode_tags(raw)
            decoded.update(self._tags)      # explicit writes win
            self._tags = decoded
        return self._tags

    @tags.setter
    def tags(self, value) -> None:
        self._tags = value
        self._raw_tags = None

    def __eq__(self, other) -> bool:
        if not isinstance(other, SamRecord):
            return NotImplemented
        return (
            self.qname, self.flag, self.tid, self.pos, self.mapq,
            self.cigar, self.mtid, self.mpos, self.tlen, self.seq,
            self.qual, self.tags) == (
            other.qname, other.flag, other.tid, other.pos, other.mapq,
            other.cigar, other.mtid, other.mpos, other.tlen, other.seq,
            other.qual, other.tags)

    def __repr__(self) -> str:
        return (f"SamRecord(qname={self.qname!r}, flag={self.flag}, "
                f"tid={self.tid}, pos={self.pos}, mapq={self.mapq}, "
                f"cigar={self.cigar!r}, mtid={self.mtid}, mpos={self.mpos}, "
                f"tlen={self.tlen}, seq={self.seq!r}, qual={self.qual!r}, "
                f"tags={self.tags!r})")

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FLAG_UNMAPPED)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FLAG_REVERSE)

    @property
    def is_duplicate(self) -> bool:
        return bool(self.flag & FLAG_DUP)

    @property
    def end_pos(self) -> int:
        """0-based exclusive reference end."""
        return self.pos + cigar_ref_len(self.cigar)

    def set_tag(self, name: str, typ: str, value) -> None:
        self.tags[name] = (typ, value)

    def get_tag(self, name: str):
        t = self.tags.get(name)
        return None if t is None else t[1]


@dataclasses.dataclass
class SamHeader:
    contigs: list[tuple[str, int]]  # (name, length), order defines tid
    read_groups: list[dict[str, str]] = dataclasses.field(default_factory=list)
    programs: list[dict[str, str]] = dataclasses.field(default_factory=list)
    sort_order: str = "unsorted"
    extra_lines: list[str] = dataclasses.field(default_factory=list)

    def tid(self, name: str) -> int:
        for i, (n, _) in enumerate(self.contigs):
            if n == name:
                return i
        return -1

    def contig_name(self, tid: int) -> str:
        return "*" if tid < 0 else self.contigs[tid][0]

    def to_text(self) -> str:
        lines = [f"@HD\tVN:1.6\tSO:{self.sort_order}"]
        for name, length in self.contigs:
            lines.append(f"@SQ\tSN:{name}\tLN:{length}")
        for rg in self.read_groups:
            lines.append("@RG\t" + "\t".join(f"{k}:{v}" for k, v in rg.items()))
        for pg in self.programs:
            lines.append("@PG\t" + "\t".join(f"{k}:{v}" for k, v in pg.items()))
        lines.extend(self.extra_lines)
        return "\n".join(lines) + "\n"

    @classmethod
    def from_text(cls, text: str) -> "SamHeader":
        h = cls(contigs=[])
        for line in text.splitlines():
            if not line.startswith("@"):
                continue
            tag = line[:3]
            fields = dict(
                f.split(":", 1) for f in line.split("\t")[1:] if ":" in f)
            if tag == "@SQ":
                h.contigs.append((fields["SN"], int(fields["LN"])))
            elif tag == "@RG":
                h.read_groups.append(fields)
            elif tag == "@PG":
                h.programs.append(fields)
            elif tag == "@HD":
                h.sort_order = fields.get("SO", "unsorted")
            else:
                h.extra_lines.append(line)
        return h


_TAG_FMT = {"A": "A", "i": "i", "f": "f", "Z": "Z", "H": "H", "B": "B",
            "c": "i", "C": "i", "s": "i", "S": "i", "I": "i"}


def record_to_sam_line(rec: SamRecord, header: SamHeader) -> str:
    fields = [
        rec.qname,
        str(rec.flag),
        header.contig_name(rec.tid),
        str(rec.pos + 1),
        str(rec.mapq),
        cigar_to_str(rec.cigar),
        ("=" if rec.mtid == rec.tid and rec.tid >= 0
         else header.contig_name(rec.mtid)),
        str(rec.mpos + 1),
        str(rec.tlen),
        rec.seq or "*",
        rec.qual or "*",
    ]
    for name, (typ, val) in sorted(rec.tags.items()):
        sam_typ = _TAG_FMT.get(typ, typ)
        fields.append(f"{name}:{sam_typ}:{val}")
    return "\t".join(fields)


def record_from_sam_line(line: str, header: SamHeader) -> SamRecord:
    f = line.rstrip("\n").split("\t")
    if len(f) < 11:
        raise InvalidParam(f"bad SAM line: {line[:60]!r}")
    rec = SamRecord(
        qname=f[0], flag=int(f[1]),
        tid=header.tid(f[2]) if f[2] != "*" else -1,
        pos=int(f[3]) - 1, mapq=int(f[4]), cigar=cigar_from_str(f[5]),
        mtid=(header.tid(f[6]) if f[6] not in ("*", "=")
              else (header.tid(f[2]) if f[6] == "=" else -1)),
        mpos=int(f[7]) - 1, tlen=int(f[8]), seq=f[9], qual=f[10])
    for tag in f[11:]:
        name, typ, val = tag.split(":", 2)
        if typ == "i":
            val = int(val)
        elif typ == "f":
            val = float(val)
        rec.tags[name] = (typ, val)
    return rec

"""VCF/gVCF codec: records, headers, text and BGZF-compressed output.

Replaces the reference's shelled-out bcftools/bgzip/tabix utility workers
(src/workers/VCFUtilsWorker.cpp: VCFConcatWorker, ZIPWorker, TabixWorker,
VCFSortWorker) with in-repo equivalents: :func:`concat_vcfs`,
:func:`write_vcf` (``.gz`` → BGZF), :func:`sort_vcf`, and a linear-scan
index (tabix replacement) in :mod:`falcon_genome_tpu_torch.io.tabix`.
"""
from __future__ import annotations

import dataclasses
import gzip
import re
from pathlib import Path

from ..utils.errors import InvalidParam
from .bgzf import BgzfWriter

MISSING = "."


@dataclasses.dataclass
class VcfRecord:
    contig: str
    pos: int                  # 1-based
    ref: str
    alts: list[str]
    id: str = MISSING
    qual: float | None = None
    filter: str = MISSING
    info: dict[str, object] = dataclasses.field(default_factory=dict)
    fmt: list[str] = dataclasses.field(default_factory=list)
    samples: list[dict[str, object]] = dataclasses.field(default_factory=list)

    @property
    def is_gvcf_block(self) -> bool:
        return "END" in self.info and self.alts[:1] == ["<NON_REF>"]

    def sort_key(self, contig_order: dict[str, int]):
        return (contig_order.get(self.contig, 1 << 30), self.pos)


def _fmt_info(info: dict[str, object]) -> str:
    if not info:
        return MISSING
    parts = []
    for k, v in info.items():
        if v is True:
            parts.append(k)
        elif isinstance(v, (list, tuple)):
            parts.append(f"{k}={','.join(str(x) for x in v)}")
        else:
            parts.append(f"{k}={v}")
    return ";".join(parts)


def _parse_info(s: str) -> dict[str, object]:
    info: dict[str, object] = {}
    if s == MISSING:
        return info
    for part in s.split(";"):
        if "=" in part:
            k, v = part.split("=", 1)
            info[k] = v
        elif part:
            info[part] = True
    return info


def _fmt_sample(fmt: list[str], sample: dict[str, object]) -> str:
    return ":".join(
        (",".join(str(x) for x in v) if isinstance(v, (list, tuple))
         else str(v)) if (v := sample.get(k, MISSING)) is not None else MISSING
        for k in fmt)


def record_to_line(rec: VcfRecord) -> str:
    qual = MISSING if rec.qual is None else (
        f"{rec.qual:.2f}".rstrip("0").rstrip(".") or "0")
    fields = [
        rec.contig, str(rec.pos), rec.id or MISSING, rec.ref,
        ",".join(rec.alts) if rec.alts else MISSING,
        qual, rec.filter or MISSING, _fmt_info(rec.info),
    ]
    if rec.fmt:
        fields.append(":".join(rec.fmt))
        fields.extend(_fmt_sample(rec.fmt, s) for s in rec.samples)
    return "\t".join(fields)


def record_from_line(line: str) -> VcfRecord:
    f = line.rstrip("\n").split("\t")
    if len(f) < 8:
        raise InvalidParam(f"bad VCF line: {line[:60]!r}")
    rec = VcfRecord(
        contig=f[0], pos=int(f[1]), id=f[2], ref=f[3],
        alts=[] if f[4] == MISSING else f[4].split(","),
        qual=None if f[5] == MISSING else float(f[5]),
        filter=f[6], info=_parse_info(f[7]))
    if len(f) > 8:
        rec.fmt = f[8].split(":")
        for col in f[9:]:
            vals = col.split(":")
            rec.samples.append(
                {k: v for k, v in zip(rec.fmt, vals)})
    return rec


@dataclasses.dataclass
class VcfHeader:
    contigs: list[tuple[str, int]] = dataclasses.field(default_factory=list)
    samples: list[str] = dataclasses.field(default_factory=list)
    meta: list[str] = dataclasses.field(default_factory=list)  # ## lines sans contig

    def to_text(self) -> str:
        lines = ["##fileformat=VCFv4.2"]
        lines += [m for m in self.meta if not m.startswith("##fileformat")]
        for name, length in self.contigs:
            lines.append(f"##contig=<ID={name},length={length}>")
        cols = ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO"]
        if self.samples:
            cols += ["FORMAT"] + self.samples
        lines.append("\t".join(cols))
        return "\n".join(lines) + "\n"

    @classmethod
    def from_lines(cls, lines: list[str]) -> "VcfHeader":
        h = cls()
        for line in lines:
            line = line.rstrip("\n")
            if line.startswith("##contig="):
                body = line[len("##contig=<"):].rstrip(">")
                fields = dict(kv.split("=", 1) for kv in body.split(",")
                              if "=" in kv)
                h.contigs.append(
                    (fields.get("ID", "?"), int(fields.get("length", 0))))
            elif line.startswith("##"):
                h.meta.append(line)
            elif line.startswith("#CHROM"):
                cols = line.split("\t")
                if len(cols) > 9:
                    h.samples = cols[9:]
        return h

    def contig_order(self) -> dict[str, int]:
        return {name: i for i, (name, _) in enumerate(self.contigs)}


STANDARD_META = [
    '##FILTER=<ID=PASS,Description="All filters passed">',
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
    '##FORMAT=<ID=AD,Number=R,Type=Integer,Description="Allelic depths">',
    '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read depth">',
    '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality">',
    '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Phred-scaled genotype likelihoods">',
    '##INFO=<ID=DP,Number=1,Type=Integer,Description="Combined depth">',
    '##INFO=<ID=AF,Number=A,Type=Float,Description="Allele frequency">',
    '##INFO=<ID=END,Number=1,Type=Integer,Description="End of gVCF block">',
    '##ALT=<ID=NON_REF,Description="Non-reference symbolic allele">',
]


def _open_out(path: str | Path):
    if str(path).endswith(".gz"):
        return _BgzfTextWriter(path)
    return open(path, "w")


class _BgzfTextWriter:
    def __init__(self, path):
        self._w = BgzfWriter(path)

    def write(self, s: str):
        self._w.write(s.encode())

    def close(self):
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_vcf(path: str | Path, header: VcfHeader,
              records: list[VcfRecord], index: bool | None = None) -> str:
    """Write a VCF; ``.gz`` outputs are BGZF and get a ``.tbi`` tabix
    index (replacing the reference's bgzip+tabix chain) unless
    ``index=False``."""
    gz = str(path).endswith(".gz")
    if index is None:
        index = gz
    if not gz or not index:
        with _open_out(path) as f:
            f.write(header.to_text())
            for r in records:
                f.write(record_to_line(r) + "\n")
        return str(path)

    from .tabix import IndexBuilder
    contig_id = {name: i for i, (name, _) in enumerate(header.contigs)}
    builder = IndexBuilder(max(len(contig_id), 1))
    w = BgzfWriter(path)
    w.write(header.to_text().encode())
    for r in records:
        v0 = w.virtual_offset
        w.write((record_to_line(r) + "\n").encode())
        v1 = w.virtual_offset
        rid = contig_id.get(r.contig, -1)
        end = int(r.info.get("END", r.pos + len(r.ref) - 1))
        builder.add(rid, r.pos - 1, end, v0, v1)
    w.close()
    builder.write_tbi(str(path) + ".tbi",
                      [name for name, _ in header.contigs])
    return str(path)


def _open_in(path: str | Path):
    p = str(path)
    if p.endswith(".gz"):
        return gzip.open(p, "rt")  # gzip handles multi-member BGZF
    return open(p)


def ensure_indexed_vcf(path: str | Path, work_dir: str | Path) -> str:
    """Path to a bgzf-compressed, tabix-indexed twin of ``path``.

    Returns ``path`` itself when it is already ``.gz`` with a ``.tbi``.
    Otherwise re-compresses it streaming — two line-scans, one record in
    memory at a time — into ``work_dir`` and builds the ``.tbi`` (the
    reference's bgzip+tabix preconditioning, VCFUtilsWorker.cpp:54-99);
    callers can then region-stream any input instead of caching whole
    files in RAM."""
    from .tabix import IndexBuilder
    p = str(path)
    if p.endswith(".gz") and Path(p + ".tbi").exists():
        return p
    Path(work_dir).mkdir(parents=True, exist_ok=True)
    name = Path(p).name
    dst = str(Path(work_dir) / (name if name.endswith(".gz")
                                else name + ".gz"))
    # pass 1: contig order (header ##contig lines, else first appearance)
    contigs: list[str] = []
    seen: set[str] = set()
    with _open_in(p) as f:
        for line in f:
            if line.startswith("##contig="):
                m = re.search(r"ID=([^,>]+)", line)
                if m and m.group(1) not in seen:
                    seen.add(m.group(1))
                    contigs.append(m.group(1))
            elif not line.startswith("#") and line.strip():
                c = line.split("\t", 1)[0]
                if c not in seen:
                    seen.add(c)
                    contigs.append(c)
    contig_id = {c: i for i, c in enumerate(contigs)}
    builder = IndexBuilder(max(len(contigs), 1))
    # pass 2: stream lines through bgzf, indexing on the fly
    w = BgzfWriter(dst)
    with _open_in(p) as f:
        for line in f:
            if line.startswith("#"):
                w.write(line.encode())
                continue
            if not line.strip():
                continue
            v0 = w.virtual_offset
            w.write(line.encode())
            v1 = w.virtual_offset
            fields = line.split("\t", 8)
            pos = int(fields[1])
            end = pos + len(fields[3]) - 1
            if len(fields) > 7 and "END=" in fields[7]:
                m = re.search(r"(?:^|;)END=(\d+)", fields[7])
                if m:
                    end = int(m.group(1))
            builder.add(contig_id.get(fields[0], -1), pos - 1, end, v0, v1)
    w.close()
    builder.write_tbi(dst + ".tbi", contigs)
    return dst


def read_vcf(path: str | Path) -> tuple[VcfHeader, list[VcfRecord]]:
    header_lines: list[str] = []
    records: list[VcfRecord] = []
    with _open_in(path) as f:
        for line in f:
            if line.startswith("#"):
                header_lines.append(line)
            elif line.strip():
                records.append(record_from_line(line))
    return VcfHeader.from_lines(header_lines), records


def sort_vcf(records: list[VcfRecord], header: VcfHeader) -> list[VcfRecord]:
    """Header-preserving coordinate sort (ref VCFSortWorker,
    VCFUtilsWorker.cpp:101-113)."""
    order = header.contig_order()
    return sorted(records, key=lambda r: r.sort_key(order))


def concat_vcfs(paths: list[str | Path], out_path: str | Path,
                sort: bool = False) -> str:
    """Concatenate per-shard VCFs (ref VCFConcatWorker,
    VCFUtilsWorker.cpp:27-52: ``bcftools concat [-a]``)."""
    if not paths:
        raise InvalidParam("no VCF shards to concatenate")
    header = None
    all_records: list[VcfRecord] = []
    for p in paths:
        h, recs = read_vcf(p)
        if header is None:
            header = h
        all_records.extend(recs)
    assert header is not None
    if sort:
        all_records = sort_vcf(all_records, header)
    return write_vcf(out_path, header, all_records)

"""FASTA reference access with ``.fai``/``.dict`` sidecar support.

The reference parses ``.dict`` sidecars to learn contig names/lengths for
interval sharding (src/config.cpp:426-467) and ``.fai`` for GenomicsDB vid
generation (src/workers/CombineGVCFsWorker.cpp:52-146); it never decodes
bases itself (bwa/GATK do).  The TPU engine decodes bases in-repo: the
reference genome is materialized as one uint8 code array per contig, ready
for device upload and windowed gather.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from ..utils.errors import FileNotFound, InvalidParam
from .dna import encode_seq_np


@dataclasses.dataclass(frozen=True)
class ContigInfo:
    name: str
    length: int
    offset: int = 0        # .fai: byte offset of first base
    line_bases: int = 0    # .fai: bases per line
    line_width: int = 0    # .fai: bytes per line (incl newline)


class ReferenceDict:
    """Ordered contig table — the parsed ``.dict``/``.fai`` sidecar."""

    def __init__(self, contigs: list[ContigInfo]):
        self.contigs = contigs
        self.by_name = {c.name: c for c in contigs}

    def __len__(self) -> int:
        return len(self.contigs)

    def __iter__(self):
        return iter(self.contigs)

    def names(self) -> list[str]:
        return [c.name for c in self.contigs]

    def total_length(self, limit: int | None = None) -> int:
        cs = self.contigs if limit is None else self.contigs[:limit]
        return sum(c.length for c in cs)

    def tid(self, name: str) -> int:
        return self.names().index(name)

    @classmethod
    def from_dict_file(cls, path: str | Path) -> "ReferenceDict":
        """Parse a Picard-style ``.dict`` (``@SQ SN:<name> LN:<len>`` lines,
        ref config.cpp:432-467)."""
        contigs = []
        p = Path(path)
        if not p.exists():
            raise FileNotFound(str(path))
        for line in p.read_text().splitlines():
            if not line.startswith("@SQ"):
                continue
            name, length = None, None
            for field in line.split("\t")[1:]:
                if field.startswith("SN:"):
                    name = field[3:]
                elif field.startswith("LN:"):
                    length = int(field[3:])
            if name is None or length is None:
                raise InvalidParam(f"malformed @SQ line in {path}: {line!r}")
            contigs.append(ContigInfo(name, length))
        return cls(contigs)

    @classmethod
    def from_fai_file(cls, path: str | Path) -> "ReferenceDict":
        contigs = []
        p = Path(path)
        if not p.exists():
            raise FileNotFound(str(path))
        for line in p.read_text().splitlines():
            if not line.strip():
                continue
            name, length, offset, line_bases, line_width = line.split("\t")[:5]
            contigs.append(ContigInfo(name, int(length), int(offset),
                                      int(line_bases), int(line_width)))
        return cls(contigs)


def _sidecar(ref_path: str | Path, ext: str) -> Path:
    p = Path(ref_path)
    if ext == "fai":
        return Path(str(p) + ".fai")
    return p.with_suffix("." + ext)


class FastaFile:
    """A FASTA reference with lazily-decoded per-contig code arrays.

    Builds (and persists) missing ``.fai``/``.dict`` sidecars rather than
    failing — the reference requires a pre-built dict (config.cpp:427-430);
    we self-serve it since we own the codec.
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)
        if not self.path.exists():
            raise FileNotFound(str(path))
        fai = _sidecar(self.path, "fai")
        if fai.exists():
            self.dict = ReferenceDict.from_fai_file(fai)
        else:
            self._scan()
            write_fai(self.path, self.dict)
        dict_path = _sidecar(self.path, "dict")
        if not dict_path.exists():
            write_dict(self.path, self.dict)
        self._cache: dict[str, np.ndarray] = {}

    def _scan(self) -> None:
        contigs: list[ContigInfo] = []
        name = None
        length = 0
        offset = 0
        line_bases = line_width = 0
        pos = 0
        with open(self.path, "rb") as f:
            for raw in f:
                if raw.startswith(b">"):
                    if name is not None:
                        contigs.append(ContigInfo(name, length, offset,
                                                  line_bases, line_width))
                    name = raw[1:].split()[0].decode()
                    length = 0
                    line_bases = line_width = 0
                    offset = pos + len(raw)
                else:
                    stripped = raw.rstrip(b"\r\n")
                    if line_bases == 0 and stripped:
                        line_bases = len(stripped)
                        line_width = len(raw)
                    length += len(stripped)
                pos += len(raw)
        if name is not None:
            contigs.append(ContigInfo(name, length, offset,
                                      line_bases, line_width))
        self.dict = ReferenceDict(contigs)

    def contig_codes(self, name: str) -> np.ndarray:
        """Full contig as uint8 codes (cached)."""
        if name not in self._cache:
            info = self.dict.by_name.get(name)
            if info is None:
                raise InvalidParam(f"unknown contig {name!r} in {self.path}")
            nlines = (info.length + info.line_bases - 1) // info.line_bases \
                if info.line_bases else 0
            nbytes = info.length + nlines * (info.line_width - info.line_bases) \
                if info.line_bases else 0
            with open(self.path, "rb") as f:
                f.seek(info.offset)
                raw = np.frombuffer(f.read(nbytes), dtype=np.uint8)
            if info.line_bases:
                # drop newline columns by reshaping full lines + remainder
                keep = raw[~np.isin(raw, (10, 13))]
            else:
                keep = raw
            self._cache[name] = encode_seq_np(keep[:info.length])
        return self._cache[name]

    def fetch_codes(self, name: str, start: int, end: int) -> np.ndarray:
        """Half-open 0-based [start, end) slice of a contig as codes."""
        return self.contig_codes(name)[start:end]


def write_fai(ref_path: str | Path, rdict: ReferenceDict) -> str:
    out = _sidecar(ref_path, "fai")
    with open(out, "w") as f:
        for c in rdict:
            f.write(f"{c.name}\t{c.length}\t{c.offset}\t{c.line_bases}\t"
                    f"{c.line_width}\n")
    return str(out)


def write_dict(ref_path: str | Path, rdict: ReferenceDict) -> str:
    out = _sidecar(ref_path, "dict")
    with open(out, "w") as f:
        f.write("@HD\tVN:1.6\tSO:unsorted\n")
        for c in rdict:
            f.write(f"@SQ\tSN:{c.name}\tLN:{c.length}\t"
                    f"UR:file:{Path(ref_path).absolute()}\n")
    return str(out)


def write_fasta(path: str | Path, contigs: dict[str, str],
                line_width: int = 60) -> str:
    """Write a FASTA file (test/simulation helper)."""
    with open(path, "w") as f:
        for name, seq in contigs.items():
            f.write(f">{name}\n")
            for i in range(0, len(seq), line_width):
                f.write(seq[i:i + line_width] + "\n")
    return str(path)

"""FASTQ(.gz) reading into batched arrays.

The reference streams FASTQ through bwa-flow in 2000-read offload chunks
(src/workers/BWAWorker.cpp:142); here the reader yields padded
(names, codes, quals, lengths) batches shaped for direct device upload.
"""
from __future__ import annotations

import dataclasses
import gzip
from pathlib import Path
from typing import Iterator

import numpy as np

from ..utils.errors import FileNotFound, InvalidParam
from .dna import encode_seq


@dataclasses.dataclass
class FastqBatch:
    """A padded batch of reads.

    codes:  (n, max_len) uint8 base codes, padded with BASE_N
    quals:  (n, max_len) uint8 phred scores, padded with 0
    lengths:(n,) int32
    names:  list[str]
    """
    names: list[str]
    codes: np.ndarray
    quals: np.ndarray
    lengths: np.ndarray

    def __len__(self) -> int:
        return len(self.names)


def _open(path: str | Path):
    p = Path(path)
    if not p.exists():
        raise FileNotFound(str(path))
    if p.suffix == ".gz":
        return gzip.open(p, "rb")
    return open(p, "rb")


def iter_fastq_records(path: str | Path) -> Iterator[tuple[str, bytes, bytes]]:
    """Yield (name, seq_ascii, qual_ascii) triples."""
    with _open(path) as f:
        while True:
            header = f.readline()
            if not header:
                return
            seq = f.readline().rstrip(b"\r\n")
            plus = f.readline()
            qual = f.readline().rstrip(b"\r\n")
            if not header.startswith(b"@") or not plus.startswith(b"+"):
                raise InvalidParam(f"malformed FASTQ record in {path}")
            if len(seq) != len(qual):
                raise InvalidParam(
                    f"FASTQ seq/qual length mismatch in {path}: "
                    f"{header[:40]!r}")
            name = header[1:].split()[0].decode()
            yield name, seq, qual


def _pack(records: list[tuple[str, bytes, bytes]], pad_to: int | None,
          phred_offset: int) -> FastqBatch:
    n = len(records)
    max_len = max((len(s) for _, s, _ in records), default=0)
    width = pad_to if pad_to else max_len
    if max_len > width:
        raise InvalidParam(
            f"read length {max_len} exceeds bucket width {width}")
    codes = np.full((n, width), 4, dtype=np.uint8)  # BASE_N pad
    quals = np.zeros((n, width), dtype=np.uint8)
    lengths = np.zeros(n, dtype=np.int32)
    names = []
    for i, (name, seq, qual) in enumerate(records):
        L = len(seq)
        codes[i, :L] = encode_seq(seq)
        quals[i, :L] = np.frombuffer(qual, dtype=np.uint8) - phred_offset
        lengths[i] = L
        names.append(name)
    return FastqBatch(names, codes, quals, lengths)


class _NativeFastqStream:
    """Chunked native FASTQ parser: one C scan per batch instead of four
    python readlines + an encode per record (~75 ms per 8k-read batch —
    serial in the align pipeline loop)."""

    CHUNK = 8 << 20

    def __init__(self, path, pad_to, phred_offset):
        self.f = _open(path)
        self.path = path
        self.buf = b""
        self.eof = False
        self.pad_to = pad_to
        self.phred_offset = phred_offset

    def next_batch(self, n: int) -> FastqBatch | None:
        from . import native_ext
        while True:
            got = native_ext.fastq_scan(
                np.frombuffer(self.buf, np.uint8), n, self.phred_offset,
                self.eof, self.pad_to)
            if got is None:
                # malformed (or lib gone mid-stream): re-parse in python
                # for the precise record-level error
                raise InvalidParam(
                    f"malformed FASTQ record in {self.path}")
            codes, quals, lens, names, name_lens, consumed = got
            if len(lens) == n or (self.eof and consumed == len(self.buf)):
                self.buf = self.buf[consumed:]
                if len(lens) == 0:
                    if self.eof:
                        return None
                    continue
                offs = np.cumsum(name_lens) - name_lens
                nb = names.tobytes()
                name_list = [
                    nb[o:o + ln].decode()
                    for o, ln in zip(offs.tolist(), name_lens.tolist())]
                return FastqBatch(name_list, codes, quals,
                                  lens.astype(np.int32))
            if self.eof:
                # complete records exhausted but trailing bytes remain
                raise InvalidParam(
                    f"malformed FASTQ record in {self.path}")
            chunk = self.f.read(self.CHUNK)
            if not chunk:
                self.eof = True
            else:
                self.buf += chunk

    def close(self):
        self.f.close()


class FastqReader:
    """Batched (optionally paired) FASTQ reader."""

    def __init__(self, fastq1: str | Path, fastq2: str | Path | None = None,
                 batch_size: int = 1024, pad_to: int | None = None,
                 phred_offset: int = 33):
        self.fastq1 = fastq1
        self.fastq2 = fastq2
        self.batch_size = batch_size
        self.pad_to = pad_to
        self.phred_offset = phred_offset

    def __iter__(self) -> Iterator[tuple[FastqBatch, FastqBatch | None]]:
        from . import native_ext
        if native_ext.available():
            yield from self._iter_native()
            return
        yield from self._iter_python()

    def _iter_native(self):
        s1 = _NativeFastqStream(self.fastq1, self.pad_to,
                                self.phred_offset)
        s2 = (_NativeFastqStream(self.fastq2, self.pad_to,
                                 self.phred_offset)
              if self.fastq2 else None)
        try:
            while True:
                b1 = s1.next_batch(self.batch_size)
                b2 = s2.next_batch(self.batch_size) if s2 else None
                if b1 is None:
                    if b2 is not None:
                        raise InvalidParam(
                            "paired FASTQ files have different read counts")
                    return
                if s2 and (b2 is None or len(b2) != len(b1)):
                    raise InvalidParam(
                        "paired FASTQ files have different read counts")
                yield b1, b2
        finally:
            s1.close()
            if s2:
                s2.close()

    def _iter_python(self):
        it1 = iter_fastq_records(self.fastq1)
        it2 = iter_fastq_records(self.fastq2) if self.fastq2 else None
        while True:
            recs1, recs2 = [], []
            for _ in range(self.batch_size):
                r1 = next(it1, None)
                if r1 is None:
                    break
                recs1.append(r1)
                if it2 is not None:
                    r2 = next(it2, None)
                    if r2 is None:
                        raise InvalidParam(
                            "paired FASTQ files have different read counts")
                    recs2.append(r2)
            if not recs1:
                if it2 is not None and next(it2, None) is not None:
                    raise InvalidParam(
                        "paired FASTQ files have different read counts")
                return
            b1 = _pack(recs1, self.pad_to, self.phred_offset)
            b2 = _pack(recs2, self.pad_to, self.phred_offset) if it2 else None
            yield b1, b2


def read_fastq(path: str | Path, pad_to: int | None = None) -> FastqBatch:
    """Read an entire (small) FASTQ into one batch."""
    return _pack(list(iter_fastq_records(path)), pad_to, 33)


def write_fastq(path: str | Path, names: list[str], seqs: list[str],
                quals: list[str]) -> str:
    """Test/simulation helper."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt") as f:
        for n, s, q in zip(names, seqs, quals):
            f.write(f"@{n}\n{s}\n+\n{q}\n")
    return str(path)

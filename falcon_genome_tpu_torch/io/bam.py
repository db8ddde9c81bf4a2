"""BAM binary codec over BGZF.

Replaces the reference's external samtools/sambamba record handling with an
in-repo codec (SURVEY.md §2 rows 11/19 re-provide list).  Spec-complete for
the record fields the pipeline produces; tag support covers the types GATK
and pipelines emit (A c C s S i I f Z B-arrays).
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from ..utils.errors import InvalidParam
from .bgzf import BgzfReader, BgzfWriter
from .sam import Cigar, SamHeader, SamRecord, cigar_query_len

_BAM_MAGIC = b"BAM\x01"

# 4-bit seq encoding ("=ACMGRSVTWYHKDBN")
_NT16 = "=ACMGRSVTWYHKDBN"
_SEQ_ENC = {c: i for i, c in enumerate(_NT16)}
_SEQ_ENC.update({c.lower(): i for i, c in enumerate(_NT16)})


_SEQ_ENC_LUT = np.full(256, 15, dtype=np.uint8)
for _c, _v in _SEQ_ENC.items():
    _SEQ_ENC_LUT[ord(_c)] = _v
_NT16_LUT = np.frombuffer(_NT16.encode(), dtype=np.uint8)


def _pack_seq(seq: str) -> bytes:
    n = len(seq)
    codes = _SEQ_ENC_LUT[np.frombuffer(seq.encode(), np.uint8)]
    if n % 2:
        codes = np.append(codes, 0)
    return ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8).tobytes()


def _unpack_seq(data: bytes, n: int) -> str:
    raw = np.frombuffer(data, np.uint8)
    out = np.empty(2 * len(raw), np.uint8)
    out[0::2] = raw >> 4
    out[1::2] = raw & 0xF
    return _NT16_LUT[out[:n]].tobytes().decode()


def reg2bin(beg: int, end: int) -> int:
    """UCSC binning (BAM spec section 5.3)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


_TAG_PACK = {
    "A": lambda v: struct.pack("<c", v.encode() if isinstance(v, str) else v),
    "c": lambda v: struct.pack("<b", v), "C": lambda v: struct.pack("<B", v),
    "s": lambda v: struct.pack("<h", v), "S": lambda v: struct.pack("<H", v),
    "i": lambda v: struct.pack("<i", v), "I": lambda v: struct.pack("<I", v),
    "f": lambda v: struct.pack("<f", v),
    "Z": lambda v: v.encode() + b"\x00",
}


def _best_int_type(v: int) -> str:
    if -128 <= v < 128:
        return "c"
    if 0 <= v < 256:
        return "C"
    if -32768 <= v < 32768:
        return "s"
    if 0 <= v < 65536:
        return "S"
    return "i"


def _encode_tags(tags: dict[str, tuple[str, object]]) -> bytes:
    out = bytearray()
    for name, (typ, val) in tags.items():
        if typ == "i":
            typ = _best_int_type(int(val))
            val = int(val)
        if typ == "B":
            sub, arr = val  # (subtype, iterable)
            out += name.encode() + b"B" + sub.encode()
            arr = list(arr)
            out += struct.pack("<i", len(arr))
            for x in arr:
                out += _TAG_PACK[sub](x)
        else:
            out += name.encode() + typ.encode() + _TAG_PACK[typ](val)
    return bytes(out)


_TAG_UNPACK = {
    "A": ("<c", 1), "c": ("<b", 1), "C": ("<B", 1), "s": ("<h", 2),
    "S": ("<H", 2), "i": ("<i", 4), "I": ("<I", 4), "f": ("<f", 4),
}


def _decode_tags(data: bytes) -> dict[str, tuple[str, object]]:
    tags: dict[str, tuple[str, object]] = {}
    i = 0
    while i + 3 <= len(data):
        name = data[i:i + 2].decode()
        typ = chr(data[i + 2])
        i += 3
        if typ in _TAG_UNPACK:
            fmt, size = _TAG_UNPACK[typ]
            (val,) = struct.unpack_from(fmt, data, i)
            i += size
            if typ == "A":
                val = val.decode()
            if typ in "cCsSI":
                typ = "i"
            tags[name] = (typ, val)
        elif typ == "Z":
            end = data.index(b"\x00", i)
            tags[name] = ("Z", data[i:end].decode())
            i = end + 1
        elif typ == "B":
            sub = chr(data[i])
            (count,) = struct.unpack_from("<i", data, i + 1)
            i += 5
            fmt, size = _TAG_UNPACK[sub]
            vals = [struct.unpack_from(fmt, data, i + k * size)[0]
                    for k in range(count)]
            i += count * size
            tags[name] = ("B", (sub, vals))
        else:
            raise InvalidParam(f"unsupported BAM tag type {typ!r}")
    return tags


def _encode_record(rec: SamRecord) -> bytes:
    name = rec.qname.encode() + b"\x00"
    cigar_bytes = b"".join(
        struct.pack("<I", (n << 4) | op) for op, n in rec.cigar)
    seq = "" if rec.seq in ("*", "") else rec.seq
    l_seq = len(seq)
    if rec.cigar and l_seq and cigar_query_len(rec.cigar) != l_seq:
        raise InvalidParam(
            f"CIGAR/query length mismatch for {rec.qname}: "
            f"{cigar_query_len(rec.cigar)} vs {l_seq}")
    seq_bytes = _pack_seq(seq)
    if rec.qual in ("*", "") or not l_seq:
        qual_bytes = b"\xff" * l_seq
    else:
        qual_bytes = (np.frombuffer(rec.qual.encode(), np.uint8)
                      - 33).astype(np.uint8).tobytes()
    raw_tags = rec._raw_tags
    if raw_tags is not None and not rec._tags:
        tag_bytes = raw_tags           # unparsed tags pass through verbatim
    else:
        tag_bytes = _encode_tags(rec.tags)
    end = rec.pos + 1 if not rec.cigar else rec.end_pos
    body = struct.pack(
        "<iiBBHHHiiii",
        rec.tid, rec.pos,
        len(name), rec.mapq, reg2bin(max(rec.pos, 0), max(end, 1)),
        len(rec.cigar), rec.flag,
        l_seq, rec.mtid, rec.mpos, rec.tlen,
    ) + name + cigar_bytes + seq_bytes + qual_bytes + tag_bytes
    return struct.pack("<i", len(body)) + body


def _decode_record(body: bytes) -> SamRecord:
    (tid, pos, l_name, mapq, _bin, n_cigar, flag, l_seq, mtid, mpos,
     tlen) = struct.unpack_from("<iiBBHHHiiii", body, 0)
    off = 32
    qname = body[off:off + l_name - 1].decode()
    off += l_name
    cigar: Cigar = []
    for _ in range(n_cigar):
        (v,) = struct.unpack_from("<I", body, off)
        cigar.append((v & 0xF, v >> 4))
        off += 4
    seq = _unpack_seq(body[off:off + (l_seq + 1) // 2], l_seq)
    off += (l_seq + 1) // 2
    qual_raw = body[off:off + l_seq]
    off += l_seq
    qual = ("*" if (not l_seq or qual_raw[:1] == b"\xff")
            else (np.frombuffer(qual_raw, np.uint8) + 33)
            .astype(np.uint8).tobytes().decode())
    tags = _decode_tags(body[off:])
    return SamRecord(qname, flag, tid, pos, mapq, cigar, mtid, mpos, tlen,
                     seq if l_seq else "*", qual, tags)


class BamWriter:
    def __init__(self, path: str | Path, header: SamHeader, level: int = 6):
        self._w = BgzfWriter(path, level)
        self.header = header
        text = header.to_text().encode()
        buf = _BAM_MAGIC + struct.pack("<i", len(text)) + text
        buf += struct.pack("<i", len(header.contigs))
        for name, length in header.contigs:
            nm = name.encode() + b"\x00"
            buf += struct.pack("<i", len(nm)) + nm + struct.pack("<i", length)
        self._w.write(buf)

    def write(self, rec: SamRecord) -> None:
        self._w.write(_encode_record(rec))

    def write_all(self, records) -> None:
        for r in records:
            self.write(r)

    def close(self) -> None:
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BamReader:
    def __init__(self, path: str | Path):
        self._r = BgzfReader(path)
        magic = self._r.read(4)
        if magic != _BAM_MAGIC:
            raise InvalidParam(f"{path} is not a BAM file")
        (l_text,) = struct.unpack("<i", self._r.read(4))
        text = self._r.read(l_text).rstrip(b"\x00").decode()
        (n_ref,) = struct.unpack("<i", self._r.read(4))
        contigs = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self._r.read(4))
            name = self._r.read(l_name)[:-1].decode()
            (l_ref,) = struct.unpack("<i", self._r.read(4))
            contigs.append((name, l_ref))
        self.header = SamHeader.from_text(text)
        if not self.header.contigs:
            self.header.contigs = contigs

    def __iter__(self):
        while True:
            size_raw = self._r.read(4)
            if len(size_raw) < 4:
                return
            (size,) = struct.unpack("<i", size_raw)
            body = self._r.read(size)
            if len(body) < size:
                raise InvalidParam("truncated BAM record")
            yield _decode_record(body)

    def close(self) -> None:
        self._r.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_bam(path: str | Path, header: SamHeader, records,
              index: bool = True) -> str:
    """Write a BAM; coordinate-sorted inputs also get a ``.bai`` index
    (replacing the reference's sambamba INDEX action)."""
    from .tabix import IndexBuilder
    builder = IndexBuilder(max(len(header.contigs), 1)) if index else None
    sorted_so_far = True
    last = (-1, -1)
    with BamWriter(path, header) as w:
        for rec in records:
            v0 = w._w.virtual_offset
            w.write(rec)
            if builder is not None and not rec.is_unmapped:
                if (rec.tid, rec.pos) < last:
                    sorted_so_far = False
                last = (rec.tid, rec.pos)
                builder.add(rec.tid, rec.pos, max(rec.end_pos, rec.pos + 1),
                            v0, w._w.virtual_offset)
    if builder is not None and sorted_so_far:
        builder.write_bai(str(path) + ".bai")
    return str(path)


def _header_bytes(header: SamHeader) -> bytes:
    text = header.to_text().encode()
    buf = _BAM_MAGIC + struct.pack("<i", len(text)) + text
    buf += struct.pack("<i", len(header.contigs))
    for name, length in header.contigs:
        nm = name.encode() + b"\x00"
        buf += struct.pack("<i", len(nm)) + nm + struct.pack("<i", length)
    return buf


def write_bam_columns(path: str | Path, header: SamHeader, cols,
                      order=None, index: bool = True,
                      level: int = 6) -> str:
    """Columnar fast path of write_bam: native record encode (threaded,
    permutation applied on the fly) + threaded BGZF + analytic virtual
    offsets for the ``.bai``.  Falls back to the record path without the
    native lib."""
    from . import native_ext
    from .columns import F_ENDPOS, F_FLAG, F_POS, F_TID
    from .sam import FLAG_UNMAPPED
    from .tabix import write_bai_arrays

    body = cols.encode(order) if native_ext.available() else None
    if body is None:
        recs = cols.to_records()
        if order is not None:
            recs = [recs[i] for i in order]
        return write_bam(path, header, recs, index=index)

    hdr = _header_bytes(header)
    stream = np.concatenate([np.frombuffer(hdr, np.uint8), body])
    comp, coffs = native_ext.bgzf_compress_mt(stream.tobytes(), level)
    from .bgzf import _EOF_BLOCK
    with open(path, "wb") as f:
        f.write(comp)
        f.write(_EOF_BLOCK)

    if index and len(cols):
        f12 = cols.fixed if order is None else cols.fixed[order]
        sizes = cols.record_sizes()
        if order is not None:
            sizes = sizes[order]      # order may be a partial selection
        u = np.zeros(len(sizes) + 1, np.int64)
        np.cumsum(sizes, out=u[1:])
        u += len(hdr)
        blk = u // 65280
        voff = (coffs[blk].astype(np.uint64) << np.uint64(16)) \
            | (u % 65280).astype(np.uint64)
        mapped = (f12[:, F_FLAG] & FLAG_UNMAPPED) == 0
        tid = f12[:, F_TID].astype(np.int64)
        pos = f12[:, F_POS].astype(np.int64)
        m_tid, m_pos = tid[mapped], pos[mapped]
        is_sorted = bool(
            np.all((m_tid[1:] > m_tid[:-1])
                   | ((m_tid[1:] == m_tid[:-1]) & (m_pos[1:] >= m_pos[:-1]))))
        if is_sorted:
            end = np.maximum(f12[:, F_ENDPOS].astype(np.int64), pos + 1)
            write_bai_arrays(
                str(path) + ".bai", max(len(header.contigs), 1),
                tid[mapped], pos[mapped], end[mapped],
                voff[:-1][mapped], voff[1:][mapped])
    return str(path)


class BamColumnsWriter:
    """Streaming columnar BAM writer: append RecordColumns chunks, get one
    BAM + ``.bai``.  Each chunk is native-encoded and BGZF-compressed on
    its own block boundary, so memory is bounded by the chunk size — the
    merge half of the reference's bucket-tree dataflow
    (src/workers/BWAWorker.cpp:134-147) without materializing the file.

    Chunks must arrive in coordinate order (already-sorted buckets); the
    writer tracks virtual offsets across chunks for the index.
    """

    def __init__(self, path: str | Path, header, level: int = 6):
        from . import native_ext
        if not native_ext.available():
            raise RuntimeError("BamColumnsWriter requires the native lib")
        self._native = native_ext
        self.path = str(path)
        self._f = open(path, "wb")
        self._level = level
        hdr = _header_bytes(header)
        comp, _ = native_ext.bgzf_compress_mt(hdr, level)
        self._f.write(comp)
        self._base = len(comp)
        self._n_ref = max(len(header.contigs), 1)
        # incremental .bai state: IndexBuilder-style chunk runs (merged
        # across write_columns boundaries) + per-ref linear minima —
        # O(bins touched), NOT O(records), so a whole-genome stream
        # through this writer stays memory-bounded
        self._runs: list[np.ndarray] = []      # (k, 4) int64/u64 rows
        self._tail: tuple[int, int, int, int] | None = None
        self._lin: dict[int, np.ndarray] = {}
        self._sorted = True
        self._last = (-1, -1)

    def write_columns(self, cols, order=None) -> None:
        from .columns import F_ENDPOS, F_FLAG, F_POS, F_TID
        from .sam import FLAG_UNMAPPED
        if len(cols) == 0:
            return
        body = cols.encode(order)
        comp, coffs = self._native.bgzf_compress_mt(body.tobytes(),
                                                    self._level)
        sizes = cols.record_sizes()
        f12 = cols.fixed
        if order is not None:
            sizes = sizes[order]
            f12 = f12[order]
        u = np.zeros(len(sizes) + 1, np.int64)
        np.cumsum(sizes, out=u[1:])
        blk = u // 65280
        voff = ((self._base + coffs[blk]).astype(np.uint64) << np.uint64(16)
                | (u % 65280).astype(np.uint64))
        self._f.write(comp)
        self._base += len(comp)
        mapped = (f12[:, F_FLAG] & FLAG_UNMAPPED) == 0
        tid = f12[:, F_TID].astype(np.int64)
        pos = f12[:, F_POS].astype(np.int64)
        m_tid, m_pos = tid[mapped], pos[mapped]
        if len(m_tid):
            from .tabix import LINEAR_SHIFT, reg2bin_vec
            if (int(m_tid[0]), int(m_pos[0])) < self._last:
                self._sorted = False
            if not bool(np.all((m_tid[1:] > m_tid[:-1])
                               | ((m_tid[1:] == m_tid[:-1])
                                  & (m_pos[1:] >= m_pos[:-1])))):
                self._sorted = False
            self._last = (int(m_tid[-1]), int(m_pos[-1]))
            end = np.maximum(f12[:, F_ENDPOS].astype(np.int64),
                             pos + 1)[mapped]
            vs = voff[:-1][mapped]
            ve = voff[1:][mapped]
            keep = (m_tid >= 0) & (m_tid < self._n_ref)
            m_tid2, beg2, end2 = m_tid[keep], m_pos[keep], end[keep]
            vs2, ve2 = vs[keep], ve[keep]
            if len(m_tid2):
                bins = reg2bin_vec(beg2, end2)
                brk = np.ones(len(m_tid2), bool)
                brk[1:] = ((m_tid2[1:] != m_tid2[:-1])
                           | (bins[1:] != bins[:-1])
                           | (ve2[:-1] != vs2[1:]))
                starts = np.flatnonzero(brk)
                ends_i = np.concatenate([starts[1:], [len(m_tid2)]]) - 1
                runs = np.empty((len(starts), 4), np.uint64)
                runs[:, 0] = m_tid2[starts].astype(np.uint64)
                runs[:, 1] = bins[starts].astype(np.uint64)
                runs[:, 2] = vs2[starts]
                runs[:, 3] = ve2[ends_i]
                if self._tail is not None:
                    t = self._tail
                    if (int(runs[0, 0]) == t[0] and int(runs[0, 1]) == t[1]
                            and int(runs[0, 2]) == t[3]):
                        runs[0, 2] = np.uint64(t[2])  # chain across chunks
                    else:
                        self._runs.append(np.asarray([t], np.uint64))
                self._tail = tuple(int(x) for x in runs[-1])
                if len(runs) > 1:
                    self._runs.append(runs[:-1])
                # linear index minima per 16 kb window
                b0 = beg2 >> LINEAR_SHIFT
                w1 = (end2 - 1) >> LINEAR_SHIFT
                for ref in np.unique(m_tid2):
                    sel = m_tid2 == ref
                    need = int(w1[sel].max()) + 1
                    lin = self._lin.get(int(ref))
                    if lin is None or len(lin) < need:
                        big = np.full(need,
                                      np.uint64(0xFFFFFFFFFFFFFFFF),
                                      np.uint64)
                        if lin is not None:
                            big[:len(lin)] = lin
                        lin = big
                        self._lin[int(ref)] = lin
                    span = int((w1[sel] - b0[sel]).max())
                    for k in range(span + 1):
                        m = b0[sel] + k <= w1[sel]
                        np.minimum.at(lin, (b0[sel] + k)[m], vs2[sel][m])

    def close(self, index: bool = True) -> str:
        import struct as _struct

        from .bgzf import _EOF_BLOCK
        from .tabix import BAI_MAGIC, build_bai_body_runs
        self._f.write(_EOF_BLOCK)
        self._f.close()
        if index and self._sorted and (self._runs or self._tail):
            if self._tail is not None:
                self._runs.append(np.asarray([self._tail], np.uint64))
                self._tail = None
            runs = np.concatenate(self._runs)
            self._runs = [runs]
            with open(self.path + ".bai", "wb") as f:
                f.write(BAI_MAGIC + _struct.pack("<i", self._n_ref)
                        + build_bai_body_runs(
                            self._n_ref, runs[:, 0].astype(np.int64),
                            runs[:, 1].astype(np.int64), runs[:, 2],
                            runs[:, 3], self._lin))
        return self.path

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _records_from_scan(blob: bytes, scan) -> list[SamRecord]:
    """Assemble SamRecords from the native columnar scan (tags stay raw)."""
    ok, fixed, offs, cig_off, cops, clens, seq_a, qual_a = scan
    if not ok:
        raise InvalidParam("truncated BAM record")
    seq_s = seq_a.tobytes().decode("ascii")
    qual_s = qual_a.tobytes().decode("ascii")
    fx = fixed.tolist()
    off_l = offs.tolist()
    cg = cig_off.tolist()
    cops_l = cops.tolist()
    clens_l = clens.tolist()
    recs: list[SamRecord] = []
    for i in range(len(fx)):
        (tid, pos, mapq, flag, lseq, mtid, mpos, tlen, nc, lname, qstar,
         _end) = fx[i]
        qo, to, tl, so = off_l[i]
        c0 = cg[i]
        cigar = list(zip(cops_l[c0:c0 + nc], clens_l[c0:c0 + nc])) \
            if nc else []
        r = SamRecord(
            blob[qo:qo + lname].decode(), flag, tid, pos, mapq, cigar,
            mtid, mpos, tlen,
            seq_s[so:so + lseq] if lseq else "*",
            "*" if qstar else qual_s[so:so + lseq])
        if tl > 0:
            r._raw_tags = blob[to:to + tl]
        recs.append(r)
    return recs


def _records_from_blob(blob: bytes) -> list[SamRecord]:
    """Decode a concatenated record stream (native scan or python)."""
    from . import native_ext
    if native_ext.available():
        return _records_from_scan(blob, native_ext.bam_scan(blob))
    recs: list[SamRecord] = []
    off = 0
    while off + 4 <= len(blob):
        (size,) = struct.unpack_from("<i", blob, off)
        if off + 4 + size > len(blob):
            raise InvalidParam("truncated BAM record")
        recs.append(_decode_record(blob[off + 4:off + 4 + size]))
        off += 4 + size
    return recs


def read_bam(path: str | Path) -> tuple[SamHeader, list[SamRecord]]:
    with BamReader(path) as r:
        return r.header, _records_from_blob(r._r.read(-1))


def read_bam_region(path: str | Path,
                    regions: list[tuple[str, int, int]]
                    ) -> tuple[SamHeader, list[SamRecord]]:
    """Records overlapping any (contig, start0, end0-exclusive) region,
    read via the ``.bai`` index — only the spanned BGZF blocks are
    decompressed (the reference gets this from ``-L`` + GATK's htsjdk;
    here it powers shard-local reads at WGS scale).  Returns records in
    coordinate order."""
    from .tabix import BaiIndex, read_bgzf_at
    with BamReader(path) as r:
        header = r.header
    bai = BaiIndex.read(str(path) + ".bai")
    out: list[SamRecord] = []
    seen: set[tuple] = set()
    for contig, beg, end in regions:
        tid = header.tid(contig)
        for u, v in bai.query_chunks(tid, beg, end):
            for rec in _records_from_blob(read_bgzf_at(path, u, v)):
                if (rec.tid == tid and rec.pos < end
                        and rec.end_pos > beg):
                    key = (rec.qname, rec.flag, rec.pos)
                    if key not in seen:
                        seen.add(key)
                        out.append(rec)
    out.sort(key=lambda r: (r.tid, r.pos))
    return header, out


def read_bam_columns(path: str | Path):
    """Columnar BAM read: (header, RecordColumns) — the native scan when
    available, else the object path bridged through from_records."""
    from . import native_ext
    from .columns import RecordColumns
    with BamReader(path) as r:
        header = r.header
        blob = r._r.read(-1)
    if native_ext.available():
        return header, RecordColumns.from_scan(blob)
    return header, RecordColumns.from_records(_records_from_blob(blob))


def read_bam_region_columns(path: str | Path,
                            regions: list[tuple[str, int, int]]):
    """Columnar region read via the ``.bai``: (header, RecordColumns) of
    records overlapping any (contig, start0, end0) region, coordinate
    order, duplicates across chunk overlaps dropped."""
    from . import native_ext
    from .columns import (F_ENDPOS, F_FLAG, F_POS, F_TID, RecordColumns)
    from .tabix import BaiIndex, read_bgzf_at
    with BamReader(path) as r:
        header = r.header
    if not native_ext.available():
        h, recs = read_bam_region(path, regions)
        return h, RecordColumns.from_records(recs)
    bai = BaiIndex.read(str(path) + ".bai")
    parts: list[RecordColumns] = []
    for contig, beg, end in regions:
        tid = header.tid(contig)
        for u, v in bai.query_chunks(tid, beg, end):
            cols = RecordColumns.from_scan(read_bgzf_at(path, u, v))
            keep = ((cols.fixed[:, F_TID] == tid)
                    & (cols.fixed[:, F_POS] < end)
                    & (cols.fixed[:, F_ENDPOS] > beg))
            if keep.all():
                parts.append(cols)       # interior chunk: no gather
            elif keep.any():
                parts.append(cols.take(np.flatnonzero(keep)))
    if not parts:
        return header, RecordColumns.from_records([])
    cols = RecordColumns.concat(parts)
    # dedup (qname-hash, flag, pos) across overlapping chunks + restore
    # coordinate order, composed into ONE gather (a take() rewrites
    # every varlen blob — the shard-read hot path wants exactly one)
    key = np.stack([cols.name_hashes().astype(np.int64),
                    cols.fixed[:, F_FLAG].astype(np.int64),
                    cols.fixed[:, F_POS].astype(np.int64)], axis=1)
    _, uniq_idx = np.unique(key, axis=0, return_index=True)
    keep = np.sort(uniq_idx)
    order = np.lexsort((cols.fixed[keep, F_POS], cols.fixed[keep, F_TID]))
    return header, cols.take(keep[order])

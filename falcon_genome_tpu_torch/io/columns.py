"""Columnar BAM record batches.

The hot pipeline stages (align emit, sort, markdup, BAM write) never need
record *objects* — they need a handful of parallel arrays.  ``RecordColumns``
is that representation: the same column layout the native scan
(``fg_bam_scan``) produces and the native encoder (``fg_bam_encode``)
consumes, so a record batch goes FASTQ → aligner → sorted BAM on disk
without a single per-record Python object.

This replaces the reference's external bwa-flow record emission +
sambamba sort (SURVEY.md §2 rows 11/19) at native speed; ``SamRecord``
(io/sam.py) remains the boundary type for the irregular, low-volume
consumers (HaplotypeCaller active regions, tests).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..utils.errors import InvalidParam
from .sam import SamRecord

# fixed (N, 12) int32 column indices (fg_bam_scan layout)
F_TID, F_POS, F_MAPQ, F_FLAG, F_LSEQ, F_MTID, F_MPOS, F_TLEN, F_NCIGAR, \
    F_LNAME, F_QSTAR, F_ENDPOS = range(12)

_REF_CONSUME_MASK = np.zeros(16, bool)
_REF_CONSUME_MASK[[0, 2, 3, 7, 8]] = True  # M D N = X


@dataclasses.dataclass
class RecordColumns:
    """A batch of BAM records as parallel column arrays.

    Variable-length fields (name, cigar, seq/qual, tags) are flat blobs
    with per-record offsets; lengths live in ``fixed``.  ``seq_mode`` is
    ``"ascii"`` (base letters) or ``"codes"`` (0..3, 4=N); ``qual_mode``
    is ``"ascii"`` (phred+33) or ``"raw"``.
    """
    fixed: np.ndarray        # (N, 12) int32
    names: np.ndarray        # uint8 blob
    name_off: np.ndarray     # (N,) int64
    cigar_ops: np.ndarray    # (T,) int32
    cigar_lens: np.ndarray   # (T,) int32
    cig_off: np.ndarray      # (N,) int64
    seq: np.ndarray          # (S,) uint8
    qual: np.ndarray         # (S,) uint8
    seq_off: np.ndarray      # (N,) int64
    tags: np.ndarray         # uint8 blob
    tag_off: np.ndarray      # (N,) int64
    tag_len: np.ndarray      # (N,) int64
    seq_mode: str = "ascii"
    qual_mode: str = "ascii"

    def __len__(self) -> int:
        return self.fixed.shape[0]

    # -- derived -------------------------------------------------------------

    def coordinate_order(self) -> np.ndarray:
        """Permutation for coordinate sort: (tid, pos), unmapped last.

        :func:`falcon_genome_tpu_torch.parallel.coordinate_order`: under
        an active multi-device mesh the argsort is the mesh's sample-sort
        (``parallel.sharded.mesh_coordinate_order``), else the host
        lexsort.  Imported here, not at the top: ``parallel`` imports
        this module."""
        from ..parallel import coordinate_order
        return coordinate_order(self)

    def record_sizes(self) -> np.ndarray:
        """(N,) int64 encoded byte size per record (incl. size prefix)."""
        f = self.fixed
        return (4 + 32 + (f[:, F_LNAME].astype(np.int64) + 1)
                + 4 * f[:, F_NCIGAR].astype(np.int64)
                + (f[:, F_LSEQ].astype(np.int64) + 1) // 2
                + f[:, F_LSEQ].astype(np.int64) + self.tag_len)

    def encode(self, order: np.ndarray | None = None) -> np.ndarray | None:
        """Concatenated BAM record bytes in ``order``; None without the
        native lib (callers fall back through to_records)."""
        from . import native_ext
        if not native_ext.available():
            return None
        sizes = self.record_sizes()
        if order is not None:
            sizes = sizes[order]      # order may be a partial selection
        rec_off = np.zeros(len(sizes) + 1, np.int64)
        np.cumsum(sizes, out=rec_off[1:])
        return native_ext.bam_encode(
            self.fixed, order, self.names, self.name_off,
            self.cigar_ops, self.cigar_lens, self.cig_off,
            self.seq, self.qual, self.seq_off,
            1 if self.seq_mode == "codes" else 0,
            1 if self.qual_mode == "raw" else 0,
            self.tags, self.tag_off, self.tag_len, rec_off)

    def name_hashes(self) -> np.ndarray:
        """(N,) uint64 content hash of each qname (native; python twin)."""
        from . import native_ext
        lens = self.fixed[:, F_LNAME]
        h = (native_ext.hash_spans(self.names, self.name_off, lens)
             if native_ext.available() else None)
        if h is not None:
            return h
        out = np.empty(len(self), np.uint64)
        M = (1 << 64) - 1
        for i in range(len(self)):
            o = int(self.name_off[i])
            hh = 0xcbf29ce484222325
            for b in self.names[o:o + int(lens[i])].tolist():
                hh = ((hh ^ b) * 0x100000001b3) & M
            hh ^= hh >> 33
            hh = (hh * 0xFF51AFD7ED558CCD) & M
            hh ^= hh >> 33
            hh = (hh * 0xC4CEB9FE1A85EC53) & M
            hh ^= hh >> 33
            out[i] = hh
        return out

    def qname(self, i: int) -> str:
        o = int(self.name_off[i])
        return self.names[o:o + int(self.fixed[i, F_LNAME])].tobytes().decode()

    # -- conversions ----------------------------------------------------------

    @classmethod
    def from_scan(cls, blob: bytes) -> "RecordColumns":
        """From the native columnar scan of a record stream."""
        from . import native_ext
        scan = native_ext.bam_scan(blob)
        if scan is None:
            raise InvalidParam("native fgio unavailable for columnar scan")
        ok, fixed, offs, cig_off, cops, clens, seq_a, qual_a = scan
        if not ok:
            raise InvalidParam("truncated BAM record")
        buf = np.frombuffer(blob, np.uint8)
        return cls(
            fixed=fixed, names=buf, name_off=offs[:, 0].copy(),
            cigar_ops=cops, cigar_lens=clens, cig_off=cig_off,
            seq=seq_a, qual=qual_a, seq_off=offs[:, 3].copy(),
            tags=buf, tag_off=offs[:, 1].copy(), tag_len=offs[:, 2].copy(),
            seq_mode="ascii", qual_mode="ascii")

    @classmethod
    def from_records(cls, records: list[SamRecord]) -> "RecordColumns":
        """Python bridge (golden model for tests / non-native fallback)."""
        from .bam import _encode_tags
        n = len(records)
        fixed = np.zeros((n, 12), np.int32)
        names_b, tags_b = bytearray(), bytearray()
        name_off = np.zeros(n, np.int64)
        tag_off = np.zeros(n, np.int64)
        tag_len = np.zeros(n, np.int64)
        cig_off = np.zeros(n, np.int64)
        cops_l: list[int] = []
        clens_l: list[int] = []
        seq_b, qual_b = bytearray(), bytearray()
        seq_off = np.zeros(n, np.int64)
        for i, r in enumerate(records):
            seq = "" if r.seq in ("*", "") else r.seq
            qstar = int(r.qual in ("*", "") or not seq)
            fixed[i] = (r.tid, r.pos, r.mapq, r.flag, len(seq), r.mtid,
                        r.mpos, r.tlen, len(r.cigar), len(r.qname), qstar,
                        r.end_pos if r.cigar else r.pos + 1)
            name_off[i] = len(names_b)
            names_b += r.qname.encode()
            cig_off[i] = len(cops_l)
            for op, ln in r.cigar:
                cops_l.append(op)
                clens_l.append(ln)
            seq_off[i] = len(seq_b)
            seq_b += seq.encode()
            qual_b += (b"\xff" * len(seq) if qstar else r.qual.encode())
            raw = r._raw_tags
            tb = raw if (raw is not None and not r._tags) \
                else _encode_tags(r.tags)
            tag_off[i] = len(tags_b)
            tag_len[i] = len(tb)
            tags_b += tb
        return cls(
            fixed=fixed,
            names=np.frombuffer(bytes(names_b), np.uint8),
            name_off=name_off,
            cigar_ops=np.asarray(cops_l, np.int32),
            cigar_lens=np.asarray(clens_l, np.int32), cig_off=cig_off,
            seq=np.frombuffer(bytes(seq_b), np.uint8),
            qual=np.frombuffer(bytes(qual_b), np.uint8), seq_off=seq_off,
            tags=np.frombuffer(bytes(tags_b), np.uint8), tag_off=tag_off,
            tag_len=tag_len, seq_mode="ascii",
            qual_mode="ascii")  # qstar rows hold 0xff fill (encoder skips)

    def to_records(self) -> list[SamRecord]:
        """Materialize SamRecord objects (tags stay raw bytes)."""
        from .dna import decode_seq
        f = self.fixed
        recs: list[SamRecord] = []
        tag_blob = self.tags.tobytes()
        names_blob = self.names.tobytes()
        if self.seq_mode == "ascii":
            seq_s = self.seq.tobytes().decode("ascii")
        qual_arr = self.qual
        for i in range(len(self)):
            (tid, pos, mapq, flag, lseq, mtid, mpos, tlen, nc, lname,
             qstar, _end) = (int(x) for x in f[i])
            no = int(self.name_off[i])
            so = int(self.seq_off[i])
            c0 = int(self.cig_off[i])
            cigar = list(zip(self.cigar_ops[c0:c0 + nc].tolist(),
                             self.cigar_lens[c0:c0 + nc].tolist()))
            if self.seq_mode == "ascii":
                seq = seq_s[so:so + lseq] if lseq else "*"
            else:
                seq = decode_seq(self.seq[so:so + lseq]) if lseq else "*"
            if qstar or not lseq:
                qual = "*"
            elif self.qual_mode == "ascii":
                qual = qual_arr[so:so + lseq].tobytes().decode("ascii")
            else:
                qual = (qual_arr[so:so + lseq] + 33).tobytes().decode()
            r = SamRecord(names_blob[no:no + lname].decode(), flag, tid,
                          pos, mapq, cigar, mtid, mpos, tlen, seq, qual)
            tl = int(self.tag_len[i])
            if tl > 0:
                to = int(self.tag_off[i])
                r._raw_tags = tag_blob[to:to + tl]
            recs.append(r)
        return recs

    def take(self, idx: np.ndarray) -> "RecordColumns":
        """Gather a subset/permutation into fresh compact columns."""
        f = self.fixed[idx]
        name_lens = f[:, F_LNAME].astype(np.int64)
        ncig = f[:, F_NCIGAR].astype(np.int64)
        lseq = f[:, F_LSEQ].astype(np.int64)
        tlen = self.tag_len[idx]

        def gather_var(blob, offs, lens):
            new_off = np.zeros(len(idx), np.int64)
            if len(idx) > 1:
                np.cumsum(lens[:-1], out=new_off[1:])
            total = int(lens.sum())
            if total == 0:
                return np.zeros(0, blob.dtype), new_off
            from . import native_ext
            nat = native_ext.gather_var(blob, offs[idx], lens, new_off,
                                        total)
            if nat is not None:
                return nat, new_off
            src = (np.repeat(offs[idx], lens)
                   + (np.arange(total) - np.repeat(new_off, lens)))
            return blob[src], new_off

        names, name_off = gather_var(self.names, self.name_off, name_lens)
        seq, seq_off = gather_var(self.seq, self.seq_off, lseq)
        qual, _ = gather_var(self.qual, self.seq_off, lseq)
        cops, cig_off = gather_var(self.cigar_ops,
                                   self.cig_off.astype(np.int64), ncig)
        clens, _ = gather_var(self.cigar_lens,
                              self.cig_off.astype(np.int64), ncig)
        tags, tag_off = gather_var(self.tags, self.tag_off, tlen)
        return RecordColumns(
            fixed=f.copy(), names=names, name_off=name_off,
            cigar_ops=cops.astype(np.int32),
            cigar_lens=clens.astype(np.int32), cig_off=cig_off,
            seq=seq, qual=qual, seq_off=seq_off, tags=tags,
            tag_off=tag_off, tag_len=tlen.copy(),
            seq_mode=self.seq_mode, qual_mode=self.qual_mode)

    @classmethod
    def concat(cls, parts: list["RecordColumns"]) -> "RecordColumns":
        if not parts:
            return cls.from_records([])
        if len(parts) == 1:
            return parts[0]
        if any(p.seq_mode != parts[0].seq_mode
               or p.qual_mode != parts[0].qual_mode for p in parts):
            raise InvalidParam("mixed column modes in concat")

        def cat(field, rebase_by=None):
            arrs = []
            base = 0
            for p in parts:
                a = getattr(p, field)
                if rebase_by is not None:
                    a = a + base
                    base += len(getattr(p, rebase_by))
                arrs.append(a)
            return np.concatenate(arrs)

        return cls(
            fixed=np.concatenate([p.fixed for p in parts]),
            names=cat("names"), name_off=cat("name_off", "names"),
            cigar_ops=cat("cigar_ops"), cigar_lens=cat("cigar_lens"),
            cig_off=cat("cig_off", "cigar_ops"),
            seq=cat("seq"), qual=cat("qual"),
            seq_off=cat("seq_off", "seq"),
            tags=cat("tags"), tag_off=cat("tag_off", "tags"),
            tag_len=cat("tag_len"),
            seq_mode=parts[0].seq_mode, qual_mode=parts[0].qual_mode)


_ASCII_CODE = np.full(256, 4, np.uint8)   # base letter -> 0..3, else 4
for _i, _b in enumerate(b"ACGT"):
    _ASCII_CODE[_b] = _i
for _i, _b in enumerate(b"acgt"):
    _ASCII_CODE[_b] = _i


def seq_codes_blob(cols: RecordColumns) -> np.ndarray:
    """The seq blob as 0..3/4 codes regardless of seq_mode."""
    if cols.seq_mode == "codes":
        return cols.seq
    return _ASCII_CODE[cols.seq]


def qual_phred_blob(cols: RecordColumns) -> np.ndarray:
    """The qual blob as raw phred regardless of qual_mode (int16; 0xff
    fill rows of qstar records come out negative — callers mask them)."""
    q = cols.qual.astype(np.int16)
    return q if cols.qual_mode == "raw" else q - 33


_CONSUME_Q_MASK = np.zeros(16, bool)
_CONSUME_Q_MASK[[0, 1, 4, 7, 8]] = True    # M I S = X
_M_LIKE_MASK = np.zeros(16, bool)
_M_LIKE_MASK[[0, 7, 8]] = True             # M = X


def expand_cigar_ops(cols: RecordColumns, sel: np.ndarray):
    """Vectorized CIGAR walk for the records in ``sel``.

    Returns per-op arrays (ops, lens, op_rec, qoff, roff) where op_rec
    indexes into ``sel`` and qoff/roff are the query/reference offsets at
    the start of each op (the running position the per-record Python walk
    would carry) — segmented exclusive prefix sums, no Python loop.
    """
    sel = np.asarray(sel, np.int64)
    ncig = cols.fixed[sel, F_NCIGAR].astype(np.int64)
    total = int(ncig.sum())
    if total == 0:
        z = np.zeros(0, np.int64)
        return (np.zeros(0, np.int32), np.zeros(0, np.int64), z, z, z)
    op_base = np.zeros(len(sel), np.int64)
    np.cumsum(ncig[:-1], out=op_base[1:])
    op_idx = (np.repeat(cols.cig_off[sel].astype(np.int64), ncig)
              + np.arange(total) - np.repeat(op_base, ncig))
    ops = cols.cigar_ops[op_idx]
    lens = cols.cigar_lens[op_idx].astype(np.int64)
    op_rec = np.repeat(np.arange(len(sel)), ncig)

    q_contrib = np.where(_CONSUME_Q_MASK[ops], lens, 0)
    r_contrib = np.where(_REF_CONSUME_MASK[ops], lens, 0)
    cq = np.cumsum(q_contrib) - q_contrib    # exclusive prefix, global
    cr = np.cumsum(r_contrib) - r_contrib
    starts = op_base                          # first-op index per record
    qoff = cq - np.repeat(cq[starts], ncig)
    roff = cr - np.repeat(cr[starts], ncig)
    return ops, lens, op_rec, qoff, roff


def expand_match_bases(cols: RecordColumns, sel: np.ndarray):
    """Per-base expansion of the aligned (M/=/X) bases of ``sel`` records.

    Returns (rec, qpos, rpos): for every aligned base, the index into
    ``sel``, the base's offset in the read, and its 0-based reference
    position.  This replaces the per-base Python CIGAR walks of covariate
    extraction and pileup (VERDICT round-1 item 3) with numpy repeats.
    """
    ops, lens, op_rec, qoff, roff = expand_cigar_ops(cols, sel)
    m = _M_LIKE_MASK[ops]
    m_lens = lens[m]
    nb = int(m_lens.sum())
    if nb == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    b_base = np.cumsum(m_lens) - m_lens
    t = np.arange(nb) - np.repeat(b_base, m_lens)
    rec = np.repeat(op_rec[m], m_lens)
    qpos = np.repeat(qoff[m], m_lens) + t
    sel = np.asarray(sel, np.int64)
    rpos = (cols.fixed[sel, F_POS].astype(np.int64)[rec]
            + np.repeat(roff[m], m_lens) + t)
    return rec, qpos, rpos


_TAG_SIZES = {ord("A"): 1, ord("c"): 1, ord("C"): 1, ord("s"): 2,
              ord("S"): 2, ord("i"): 4, ord("I"): 4, ord("f"): 4}


def _find_tag(span: bytes, tag: bytes) -> str | None:
    """Exact forward walk of one record's BAM tag stream."""
    off = 0
    n = len(span)
    while off + 3 <= n:
        key = span[off:off + 2]
        typ = span[off + 2]
        off += 3
        if typ in (ord("Z"), ord("H")):
            end = span.find(b"\x00", off)
            end = end if end >= 0 else n
            if key == tag:
                return span[off:end].decode()
            off = end + 1
        elif typ in _TAG_SIZES:
            off += _TAG_SIZES[typ]
        elif typ == ord("B"):
            sub = span[off]
            (cnt,) = np.frombuffer(span[off + 1:off + 5], "<i4")
            off += 5 + _TAG_SIZES[sub] * int(cnt)
        else:
            return None  # malformed stream: stop
    return None


def tag_string_values(cols: RecordColumns, tag: bytes,
                      idx: np.ndarray | None = None) -> list[str | None]:
    """Per-record string value of a 2-byte tag (e.g. b"RG") from the raw
    BAM tag blobs, for all records or the subset ``idx``.  Low-volume
    helper (one stream walk per record)."""
    blob = cols.tags.tobytes()
    rng = range(len(cols)) if idx is None else idx
    out: list[str | None] = []
    for i in rng:
        o = int(cols.tag_off[i])
        out.append(_find_tag(blob[o:o + int(cols.tag_len[i])], tag))
    return out

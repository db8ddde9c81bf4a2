"""ctypes bindings for the fgio C++ extension (native/fgio.cpp).

Auto-builds the shared library on first use (g++ + zlib, both baked into
the image); every entry point has a pure-Python twin that remains the
correctness reference, and callers fall back to it when the build is
unavailable.
"""
from __future__ import annotations

import ctypes
import logging
import subprocess
from pathlib import Path

import numpy as np

log = logging.getLogger("falcon_genome_tpu")

_ROOT = Path(__file__).resolve().parent.parent.parent
_SO = _ROOT / "native" / "build" / "libfgio.so"
_SRC = _ROOT / "native" / "fgio.cpp"

_lib = None
_tried = False


def load() -> ctypes.CDLL | None:
    """Load (building if needed) the native library; None on failure."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
            subprocess.run(["sh", str(_ROOT / "native" / "build.sh")],
                           check=True, capture_output=True, timeout=120)
        lib = ctypes.CDLL(str(_SO))
        lib.fg_bgzf_bound.restype = ctypes.c_int64
        lib.fg_bgzf_bound.argtypes = [ctypes.c_int64]
        lib.fg_bgzf_compress.restype = ctypes.c_int64
        lib.fg_bgzf_compress.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int64]
        lib.fg_minimizers.restype = ctypes.c_int64
        lib.fg_minimizers.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.fg_sw_traceback_batch.restype = None
        lib.fg_sw_traceback_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.fg_ops_rle_batch.restype = None
        lib.fg_ops_rle_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.fg_assemble_region.restype = ctypes.c_int64
        lib.fg_assemble_region.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.fg_bgzf_compress_mt.restype = ctypes.c_int64
        lib.fg_bgzf_compress_mt.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.fg_bam_encode.restype = None
        lib.fg_bam_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.fg_hash_spans.restype = None
        lib.fg_hash_spans.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p]
        lib.fg_bam_scan_sizes.restype = None
        lib.fg_bam_scan_sizes.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.fg_bam_scan.restype = None
        lib.fg_bam_scan.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.fg_gather_var.restype = None
        lib.fg_gather_var.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.fg_chain_anchors.restype = ctypes.c_int64
        lib.fg_chain_anchors.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.fg_fastq_scan_sizes.restype = None
        lib.fg_fastq_scan_sizes.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_void_p]
        lib.fg_fastq_fill.restype = ctypes.c_int64
        lib.fg_fastq_fill.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.fg_seed_and_chain.restype = None
        lib.fg_seed_and_chain.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.fg_minimizers_batch.restype = None
        lib.fg_minimizers_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.fg_bqsr_apply.restype = None
        lib.fg_bqsr_apply.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p]
        # (fixed, sel, nsel, rg, cig_off, cops, clens, seq_off, seq,
        #  qual, refcat, ref_total, tid_off, tid_len, known, 6× hist)
        lib.fg_bqsr_hist.restype = None
        lib.fg_bqsr_hist.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        _lib = lib
        log.debug("loaded native fgio: %s", _SO)
    except Exception as e:  # missing toolchain → python fallback
        log.warning("native fgio unavailable (%s); using python fallbacks",
                    e)
        _lib = None
    return _lib


def available() -> bool:
    return load() is not None


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def bgzf_compress(data: bytes, level: int = 6) -> bytes | None:
    lib = load()
    if lib is None:
        return None
    n = len(data)
    cap = lib.fg_bgzf_bound(n)
    dst = np.empty(cap, np.uint8)
    src = np.frombuffer(data, np.uint8)
    out = lib.fg_bgzf_compress(
        src.ctypes.data, n, level, dst.ctypes.data, cap)
    if out < 0:
        return None
    return dst[:out].tobytes()


def gather_var(blob: np.ndarray, offs: np.ndarray, lens: np.ndarray,
               out_off: np.ndarray, total: int):
    """Varlen gather ``out[i] = blob[offs[i]:offs[i]+lens[i]]`` in one
    memcpy loop (byte offsets/lengths; any element dtype — caller scales
    by itemsize).  Returns the gathered blob or None without the ext."""
    lib = load()
    if lib is None:
        return None
    blob = np.ascontiguousarray(blob)
    esz = blob.dtype.itemsize
    offs = np.ascontiguousarray(offs, np.int64) * esz
    lens_b = np.ascontiguousarray(lens, np.int64) * esz
    out_b = np.ascontiguousarray(out_off, np.int64) * esz
    # the native loop is a raw memcpy with no bounds checks — fail loudly
    # on inconsistent offsets like the numpy fallback (blob[src]) would,
    # instead of silently over-reading/writing the heap
    if len(offs):
        if int((offs + lens_b).max()) > blob.nbytes or int(offs.min()) < 0:
            raise IndexError("gather_var: src range exceeds blob")
        if int((out_b + lens_b).max()) > total * esz or int(out_b.min()) < 0:
            raise IndexError("gather_var: dst range exceeds output")
        if int(lens_b.min()) < 0:
            raise IndexError("gather_var: negative length")
    out = np.empty(total, blob.dtype)
    lib.fg_gather_var(blob.ctypes.data, offs.ctypes.data,
                      lens_b.ctypes.data, out_b.ctypes.data,
                      len(offs), out.ctypes.data)
    return out


def bqsr_hist(fixed, sel, rg, cig_off, cops, clens, seq_off, seq, qual,
              refcat, tid_off, tid_len, known, nrg: int):
    """One-pass BaseRecalibrator histograms (see fg_bqsr_hist).  Returns
    (qual_obs, qual_err, cyc_obs, cyc_err, ctx_obs, ctx_err) float64
    arrays shaped (nrg,94), (nrg,94,512), (nrg,94,16) — or None without
    the native lib."""
    lib = load()
    if lib is None:
        return None
    MAXQ, MAXC, NCTX = 94, 512, 16
    fixed = np.ascontiguousarray(fixed, np.int32)
    sel = np.ascontiguousarray(sel, np.int64)
    rg = np.ascontiguousarray(rg, np.int32)
    cig_off = np.ascontiguousarray(cig_off, np.int64)
    cops = np.ascontiguousarray(cops, np.int32)
    clens = np.ascontiguousarray(clens, np.int32)
    seq_off = np.ascontiguousarray(seq_off, np.int64)
    seq = np.ascontiguousarray(seq, np.uint8)
    qual = np.ascontiguousarray(qual, np.uint8)
    refcat = np.ascontiguousarray(refcat, np.uint8)
    tid_off = np.ascontiguousarray(tid_off, np.int64)
    tid_len = np.ascontiguousarray(tid_len, np.int64)
    kptr = 0
    if known is not None:
        known = np.ascontiguousarray(known, np.uint8)
        kptr = known.ctypes.data
    outs = [np.zeros((nrg, MAXQ), np.float64),
            np.zeros((nrg, MAXQ), np.float64),
            np.zeros((nrg, MAXQ, MAXC), np.float64),
            np.zeros((nrg, MAXQ, MAXC), np.float64),
            np.zeros((nrg, MAXQ, NCTX), np.float64),
            np.zeros((nrg, MAXQ, NCTX), np.float64)]
    lib.fg_bqsr_hist(
        fixed.ctypes.data, sel.ctypes.data, len(sel), rg.ctypes.data,
        cig_off.ctypes.data, cops.ctypes.data, clens.ctypes.data,
        seq_off.ctypes.data, seq.ctypes.data, qual.ctypes.data,
        refcat.ctypes.data, len(refcat),
        tid_off.ctypes.data, tid_len.ctypes.data, kptr,
        outs[0].ctypes.data, outs[1].ctypes.data, outs[2].ctypes.data,
        outs[3].ctypes.data, outs[4].ctypes.data, outs[5].ctypes.data)
    return tuple(outs)


def bqsr_apply(fixed, sel, rg, seq_off, seq, qual_in, table,
               preserve_below: int, in_delta: int, out_delta: int,
               qual_out) -> bool:
    """Per-base ApplyBQSR via lookup table (see fg_bqsr_apply); writes
    into qual_out in place.  False without the native lib."""
    lib = load()
    if lib is None:
        return False
    fixed = np.ascontiguousarray(fixed, np.int32)
    sel = np.ascontiguousarray(sel, np.int64)
    rg = np.ascontiguousarray(rg, np.int32)
    seq_off = np.ascontiguousarray(seq_off, np.int64)
    seq = np.ascontiguousarray(seq, np.uint8)
    qual_in = np.ascontiguousarray(qual_in, np.uint8)
    table = np.ascontiguousarray(table, np.uint8)
    lib.fg_bqsr_apply(
        fixed.ctypes.data, sel.ctypes.data, len(sel), rg.ctypes.data,
        seq_off.ctypes.data, seq.ctypes.data, qual_in.ctypes.data,
        table.ctypes.data, preserve_below, in_delta, out_delta,
        qual_out.ctypes.data)
    return True


def minimizers(codes: np.ndarray, k: int, w: int):
    lib = load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    n = len(codes)
    nk = max(n - k + 1, 1)
    out_h = np.empty(nk, np.uint64)
    out_p = np.empty(nk, np.int64)
    out_s = np.empty(nk, np.uint8)
    cnt = lib.fg_minimizers(codes.ctypes.data, n, k, w,
                            out_h.ctypes.data, out_p.ctypes.data,
                            out_s.ctypes.data)
    return out_h[:cnt], out_p[:cnt], out_s[:cnt].astype(bool)


def minimizers_batch(codes2d: np.ndarray, lens: np.ndarray, k: int,
                     w: int):
    """Minimizers for a whole (n_reads, stride) batch in ONE native call
    (threaded across reads).  Returns (hashes, positions, strands,
    offs, counts): read i's entries are the first counts[i] at
    offs[i].  None without the lib."""
    lib = load()
    if lib is None:
        return None
    codes2d = np.ascontiguousarray(codes2d, np.uint8)
    lens32 = np.ascontiguousarray(lens, np.int32)
    n = len(lens32)
    cap = np.maximum(lens32.astype(np.int64) - k + 1, 0)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(cap, out=offs[1:])
    total = int(offs[-1])
    out_h = np.empty(total, np.uint64)
    out_p = np.empty(total, np.int64)
    out_s = np.empty(total, np.uint8)
    counts = np.zeros(n, np.int64)
    lib.fg_minimizers_batch(
        codes2d.ctypes.data, codes2d.shape[1], lens32.ctypes.data, n,
        k, w, offs.ctypes.data, out_h.ctypes.data, out_p.ctypes.data,
        out_s.ctypes.data, counts.ctypes.data)
    return out_h, out_p, out_s, offs, counts


def fastq_scan(buf: np.ndarray, max_recs: int, phred_offset: int,
               final_chunk: bool, width: int | None = None):
    """Parse up to max_recs complete FASTQ records from a byte buffer.

    Returns (codes, quals, lens, names_blob, name_lens, consumed) or
    None (lib unavailable / malformed — caller re-parses in python for
    the precise error)."""
    lib = load()
    if lib is None:
        return None
    out5 = np.zeros(5, np.int64)
    lib.fg_fastq_scan_sizes(buf.ctypes.data, len(buf), max_recs,
                            1 if final_chunk else 0, out5.ctypes.data)
    n_recs, maxlen, _, namebytes, ok = (int(x) for x in out5)
    if not ok:
        return None
    w = width if width else maxlen
    if maxlen > w:
        return None
    codes = np.full((n_recs, max(w, 1)), 4, np.uint8)
    quals = np.zeros((n_recs, max(w, 1)), np.uint8)
    lens = np.zeros(n_recs, np.int32)
    names = np.zeros(max(namebytes, 1), np.uint8)
    name_lens = np.zeros(n_recs, np.int32)
    consumed = lib.fg_fastq_fill(
        buf.ctypes.data, len(buf), n_recs, codes.shape[1], phred_offset,
        1 if final_chunk else 0, codes.ctypes.data, quals.ctypes.data,
        lens.ctypes.data, names.ctypes.data, name_lens.ctypes.data)
    if consumed < 0:
        return None
    return codes, quals, lens, names, name_lens, int(consumed)


def seed_and_chain(codes: np.ndarray, lens: np.ndarray, k: int, w: int,
                   idx_hash: np.ndarray, idx_pos: np.ndarray,
                   idx_strand: np.ndarray, max_hits: int, diag_band: int,
                   min_seeds: int, max_cands: int):
    """Fused batch seeding + diagonal chaining (aligner.candidate_arrays
    twin).  Returns (diag, rev, nseeds, span, counts) as (n_reads, K)
    slot arrays + per-read counts, or None when unavailable (positions
    must be uint32 — i.e. genomes < 4.3 Gbp)."""
    lib = load()
    if lib is None or idx_pos.dtype != np.uint32:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    lens = np.ascontiguousarray(lens, np.int32)
    n = codes.shape[0]
    K = max_cands
    out_diag = np.zeros((n, K), np.int64)
    out_rev = np.zeros((n, K), np.uint8)
    out_nseeds = np.zeros((n, K), np.int32)
    out_span = np.zeros((n, K), np.int64)
    out_counts = np.zeros(n, np.int32)
    lib.fg_seed_and_chain(
        codes.ctypes.data, codes.shape[1], lens.ctypes.data, n, k, w,
        idx_hash.ctypes.data, idx_pos.ctypes.data, idx_strand.ctypes.data,
        len(idx_hash), max_hits, diag_band, min_seeds, K,
        out_diag.ctypes.data, out_rev.ctypes.data, out_nseeds.ctypes.data,
        out_span.ctypes.data, out_counts.ctypes.data)
    return out_diag, out_rev, out_nseeds, out_span, out_counts


def ops_rle_batch(packed: np.ndarray, max_steps: int, read_start: np.ndarray,
                  read_end: np.ndarray, best: np.ndarray,
                  read_lens: np.ndarray, max_ops: int = 160):
    """RLE the packed (S/4, B) device traceback op stream into per-lane
    CIGARs.  Returns (ops, lens, ncigar): (B, max_ops) int32 ×2 + (B,)."""
    lib = load()
    if lib is None:
        return None
    packed = np.ascontiguousarray(packed, np.uint8)
    S4, B = packed.shape
    read_start = np.ascontiguousarray(read_start, np.int32)
    read_end = np.ascontiguousarray(read_end, np.int32)
    best = np.ascontiguousarray(best, np.int32)
    read_lens = np.ascontiguousarray(read_lens, np.int32)
    out_ops = np.zeros((B, max_ops), np.int32)
    out_lens = np.zeros((B, max_ops), np.int32)
    out_nc = np.zeros(B, np.int32)
    lib.fg_ops_rle_batch(
        packed.ctypes.data, S4, B, max_steps, read_start.ctypes.data,
        read_end.ctypes.data, best.ctypes.data, read_lens.ctypes.data,
        max_ops, out_ops.ctypes.data, out_lens.ctypes.data,
        out_nc.ctypes.data)
    return out_ops, out_lens, out_nc


def assemble_region(ref: np.ndarray, reads: list[np.ndarray],
                    kmer_sizes: tuple[int, ...], min_mult: int,
                    max_haps: int):
    """Native de Bruijn assembly. Returns (haplotypes, k, fallback) or
    None when the lib is unavailable."""
    lib = load()
    if lib is None:
        return None
    ref = np.ascontiguousarray(ref, np.uint8)
    offs = np.zeros(len(reads) + 1, np.int64)
    for i, r in enumerate(reads):
        offs[i + 1] = offs[i] + len(r)
    blob = (np.concatenate([np.ascontiguousarray(r, np.uint8)
                            for r in reads])
            if reads else np.zeros(0, np.uint8))
    ks = np.asarray(kmer_sizes, np.int32)
    cap = max_haps * (len(ref) + 64) + 64
    out = np.empty(cap, np.uint8)
    out_offs = np.zeros(max_haps + 1, np.int64)
    out_k = np.zeros(1, np.int32)
    out_fb = np.zeros(1, np.int32)
    n = lib.fg_assemble_region(
        ref.ctypes.data, len(ref),
        blob.ctypes.data if len(blob) else None, offs.ctypes.data,
        len(reads), ks.ctypes.data, len(ks), min_mult, max_haps,
        out.ctypes.data, cap, out_offs.ctypes.data, out_k.ctypes.data,
        out_fb.ctypes.data)
    if n < 0:
        return None
    haps = [out[out_offs[i]:out_offs[i + 1]].copy() for i in range(n)]
    return haps, int(out_k[0]), bool(out_fb[0])


def bgzf_compress_mt(data, level: int = 6, nthreads: int = 0):
    """Threaded BGZF compression.  Returns (bytes, block_coffs int64
    (nblocks+1,)) or None when the lib is unavailable.  block_coffs[i] is
    the compressed offset of the block covering uncompressed bytes
    [i*65280, (i+1)*65280) — the key to analytic virtual offsets."""
    lib = load()
    if lib is None:
        return None
    if nthreads <= 0:
        import os
        nthreads = min(os.cpu_count() or 1, 8)
    src = np.frombuffer(data, np.uint8) if isinstance(data, (bytes,
                        bytearray, memoryview)) else np.ascontiguousarray(
                            data, np.uint8)
    n = len(src)
    cap = lib.fg_bgzf_bound(n)
    dst = np.empty(cap, np.uint8)
    nblocks = max((n + 65279) // 65280, 0)
    coffs = np.zeros(nblocks + 1, np.int64)
    out = lib.fg_bgzf_compress_mt(
        src.ctypes.data if n else None, n, level, nthreads,
        dst.ctypes.data, cap, coffs.ctypes.data)
    if out < 0:
        return None
    return dst[:out].tobytes(), coffs


def bam_encode(fixed, perm, names, name_off, cops, clens, cig_off,
               seq, qual, seq_off, seq_mode: int, qual_mode: int,
               tags, tag_off, tag_len, rec_off, nthreads: int = 0):
    """Columnar → concatenated BAM record bytes (uncompressed stream).

    rec_off (N+1 int64) gives each OUTPUT record's byte offset (computed
    python-side from the permuted sizes); returns the filled buffer or
    None when the lib is unavailable."""
    lib = load()
    if lib is None:
        return None
    if nthreads <= 0:
        import os
        nthreads = min(os.cpu_count() or 1, 8)
    fixed = np.ascontiguousarray(fixed, np.int32)
    perm_a = (np.ascontiguousarray(perm, np.int64)
              if perm is not None else None)
    # output count: a partial perm writes len(perm) records
    N = len(perm_a) if perm_a is not None else fixed.shape[0]
    names = np.ascontiguousarray(names, np.uint8)
    name_off = np.ascontiguousarray(name_off, np.int64)
    cops = np.ascontiguousarray(cops, np.int32)
    clens = np.ascontiguousarray(clens, np.int32)
    cig_off = np.ascontiguousarray(cig_off, np.int64)
    seq = np.ascontiguousarray(seq, np.uint8)
    qual = np.ascontiguousarray(qual, np.uint8)
    seq_off = np.ascontiguousarray(seq_off, np.int64)
    tags = np.ascontiguousarray(tags, np.uint8)
    tag_off = np.ascontiguousarray(tag_off, np.int64)
    tag_len = np.ascontiguousarray(tag_len, np.int64)
    rec_off = np.ascontiguousarray(rec_off, np.int64)
    out = np.empty(int(rec_off[-1]), np.uint8)
    lib.fg_bam_encode(
        fixed.ctypes.data, perm_a.ctypes.data if perm_a is not None else None,
        N, names.ctypes.data, name_off.ctypes.data,
        cops.ctypes.data, clens.ctypes.data, cig_off.ctypes.data,
        seq.ctypes.data, qual.ctypes.data, seq_off.ctypes.data,
        seq_mode, qual_mode, tags.ctypes.data, tag_off.ctypes.data,
        tag_len.ctypes.data, rec_off.ctypes.data, out.ctypes.data, nthreads)
    return out


def hash_spans(blob: np.ndarray, offs: np.ndarray, lens: np.ndarray
               ) -> np.ndarray | None:
    """64-bit content hash per (offset, length) span of blob."""
    lib = load()
    if lib is None:
        return None
    blob = np.ascontiguousarray(blob, np.uint8)
    offs = np.ascontiguousarray(offs, np.int64)
    lens = np.ascontiguousarray(lens, np.int32)
    out = np.empty(len(offs), np.uint64)
    lib.fg_hash_spans(blob.ctypes.data, offs.ctypes.data, lens.ctypes.data,
                      len(offs), out.ctypes.data)
    return out


def bam_scan(blob: bytes):
    """Columnar scan of a concatenated BAM record stream.

    Returns (ok, fixed (N,12) i32, offs (N,4) i64, cig_off (N,) i64,
    cigar_ops/lens (T,) i32, seq_ascii/qual_ascii (S,) u8) or None when
    the native lib is unavailable.  ok=False flags a truncated stream."""
    lib = load()
    if lib is None:
        return None
    src = np.frombuffer(blob, np.uint8)
    n = len(blob)
    sizes = np.zeros(4, np.int64)
    lib.fg_bam_scan_sizes(src.ctypes.data if n else None, n,
                          sizes.ctypes.data)
    nrec, tseq, tcig, ok = (int(x) for x in sizes)
    fixed = np.zeros((nrec, 12), np.int32)
    offs = np.zeros((nrec, 4), np.int64)
    cig_off = np.zeros(max(nrec, 1), np.int64)
    cops = np.zeros(max(tcig, 1), np.int32)
    clens = np.zeros(max(tcig, 1), np.int32)
    seq = np.zeros(max(tseq, 1), np.uint8)
    qual = np.zeros(max(tseq, 1), np.uint8)
    if nrec:
        lib.fg_bam_scan(src.ctypes.data, n, fixed.ctypes.data,
                        offs.ctypes.data, cig_off.ctypes.data,
                        cops.ctypes.data, clens.ctypes.data,
                        seq.ctypes.data, qual.ctypes.data)
    return (bool(ok), fixed, offs, cig_off[:nrec], cops[:tcig],
            clens[:tcig], seq[:tseq], qual[:tseq])

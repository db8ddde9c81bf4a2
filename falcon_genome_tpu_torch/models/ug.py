"""UnifiedGenotyper-class pileup caller (legacy path).

Mirrors the reference's UGWorker (SURVEY.md §2 row 23,
src/workers/UGWorker.cpp): per-position diploid genotyping straight from
the pileup, no assembly — the classic pre-HaplotypeCaller model.  SNVs
only (as UG's default SNP mode); indel discovery belongs to the
HaplotypeCaller path.

Vectorized: per-position base/qual columns are numpy arrays; genotype
likelihoods use the same stable log-sum math as the HC genotyper.

Port of ``falcon_genome_tpu/models/ug.py`` (host code, no kernel).
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from ..io.dna import decode_seq, encode_seq
from ..io.sam import CIGAR_D, CIGAR_I, CIGAR_M, CIGAR_S, SamRecord
from ..io.vcf import VcfRecord


@dataclasses.dataclass
class UGParams:
    min_base_qual: int = 17
    min_mapq: int = 10
    min_call_qual: float = 10.0
    min_depth: int = 2


def _pileup_columns(records: list[SamRecord], start: int, end: int):
    """(bases, quals) lists per position over [start, end)."""
    n = end - start
    bases: list[list[int]] = [[] for _ in range(n)]
    quals: list[list[int]] = [[] for _ in range(n)]
    for rec in records:
        if rec.is_unmapped or rec.is_duplicate or rec.flag & 0x900:
            continue
        if rec.seq in ("*", ""):
            continue
        seq = encode_seq(rec.seq)
        q = (np.frombuffer(rec.qual.encode(), np.uint8) - 33
             if rec.qual not in ("*", "")
             else np.full(len(seq), 30, np.uint8))
        i, rpos = 0, rec.pos
        for op, ln in rec.cigar:
            if op == CIGAR_M:
                lo = max(rpos, start)
                hi = min(rpos + ln, end)
                for p in range(lo, hi):
                    off = i + (p - rpos)
                    bases[p - start].append(int(seq[off]))
                    quals[p - start].append(int(q[off]))
                i += ln
                rpos += ln
            elif op in (CIGAR_I, CIGAR_S):
                i += ln
            elif op == CIGAR_D:
                rpos += ln
    return bases, quals


def call_pileup(records: list[SamRecord], ref: np.ndarray, contig: str,
                start: int, end: int,
                params: UGParams = UGParams()) -> list[VcfRecord]:
    reads = [r for r in records if r.mapq >= params.min_mapq]
    bases, quals = _pileup_columns(reads, start, end)
    out: list[VcfRecord] = []
    for off in range(end - start):
        b = np.asarray(bases[off], np.int32)
        q = np.asarray(quals[off], np.int32)
        keep = (q >= params.min_base_qual) & (b < 4)
        b, q = b[keep], q[keep]
        if len(b) < params.min_depth:
            continue
        refb = int(ref[start + off])
        if refb > 3:
            continue
        counts = np.bincount(b, minlength=4)
        alts = [a for a in np.argsort(-counts)
                if a != refb and counts[a] >= 2]
        if not alts:
            continue
        alleles = [refb] + [int(a) for a in alts]
        err = np.power(10.0, -q / 10.0)
        # P(base | allele): (n, n_alleles)
        pmat = np.where(b[:, None] == np.asarray(alleles)[None, :],
                        1.0 - err[:, None], err[:, None] / 3.0)
        logp = np.log10(np.maximum(pmat, 1e-30))
        genotypes = list(itertools.combinations_with_replacement(
            range(len(alleles)), 2))
        gls = np.zeros(len(genotypes))
        for gi, gt in enumerate(genotypes):
            stacked = logp[:, list(gt)]
            m = stacked.max(axis=1)
            gls[gi] = float(
                (m + np.log10(np.power(10.0, stacked - m[:, None])
                              .mean(axis=1))).sum())
        pls = np.rint(-10.0 * (gls - gls.max())).astype(np.int64)
        best = int(np.argmin(pls))
        gt = genotypes[best]
        if gt == (0, 0):
            continue
        qual = float(pls[0])
        if qual < params.min_call_qual:
            continue
        sorted_pls = np.sort(pls)
        gq = int(min(99, sorted_pls[1] - sorted_pls[0]))
        ad = [int(counts[a]) for a in alleles]
        out.append(VcfRecord(
            contig=contig, pos=start + off + 1,
            ref=decode_seq(np.array([refb], np.uint8)),
            alts=[decode_seq(np.array([a], np.uint8)) for a in alleles[1:]],
            qual=qual, filter="PASS", info={"DP": int(len(b))},
            fmt=["GT", "AD", "DP", "GQ", "PL"],
            samples=[{"GT": "/".join(str(x) for x in sorted(gt)),
                      "AD": ad, "DP": int(len(b)), "GQ": gq,
                      "PL": pls.tolist()}]))
    return out

"""Diploid genotyping from read×haplotype likelihoods.

The math of GATK's HaplotypeCallerGenotypingEngine, fed by the PairHMM TPU
kernel's log10 P(read|hap) matrix:

* variant events are read off each assembled haplotype's alignment to the
  reference window (SNPs, insertions, deletions, VCF-anchored);
* per-site allele likelihood of a read = max over haplotypes carrying that
  allele;
* diploid genotype likelihood GL(a,b) = Σ_r log10(½·10^L(r|a) + ½·10^L(r|b));
* PLs are phred-normalized; QUAL is the hom-ref PL.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from falcon_genome_tpu.io.dna import decode_seq
from falcon_genome_tpu.io.sam import CIGAR_D, CIGAR_I, CIGAR_M, CIGAR_S
from falcon_genome_tpu.io.vcf import VcfRecord
from ..ops.sw_ref import SWResult


@dataclasses.dataclass(frozen=True, order=True)
class VariantEvent:
    """A VCF-anchored event on the reference window (pos is window-local,
    0-based; ref/alt are code-decoded strings)."""
    pos: int
    ref: str
    alt: str


def events_from_alignment(hap: np.ndarray, ref: np.ndarray,
                          res: SWResult) -> list[VariantEvent] | None:
    """Extract events from a haplotype→reference-window alignment.

    Returns None if the alignment clips the haplotype (assembly anchors
    both ends on the reference, so clipping means a misassembly).
    """
    events: list[VariantEvent] = []
    i, j = 0, res.ref_start
    for op, n in res.cigar:
        if op == CIGAR_S:
            if n > 2:
                return None
            i += n
        elif op == CIGAR_M:
            hseg = hap[i:i + n]
            rseg = ref[j:j + n]
            for t in np.nonzero((hseg != rseg) & (hseg != 4) & (rseg != 4))[0]:
                events.append(VariantEvent(
                    j + int(t), decode_seq(rseg[t:t + 1]),
                    decode_seq(hseg[t:t + 1])))
            i += n
            j += n
        elif op == CIGAR_I:
            if j == 0:
                return None
            anchor = decode_seq(ref[j - 1:j])
            events.append(VariantEvent(
                j - 1, anchor, anchor + decode_seq(hap[i:i + n])))
            i += n
        elif op == CIGAR_D:
            if j == 0:
                return None
            anchor = decode_seq(ref[j - 1:j])
            events.append(VariantEvent(
                j - 1, anchor + decode_seq(ref[j:j + n]), anchor))
            j += n
    return events


@dataclasses.dataclass
class SiteCall:
    pos: int                  # window-local 0-based anchor position
    ref: str
    alts: list[str]
    gt: tuple[int, int]
    pls: list[int]            # genotype PLs, diploid ordering
    gq: int
    qual: float
    ad: list[int]
    dp: int


def _gl_to_pl(gls: np.ndarray) -> np.ndarray:
    pl = -10.0 * (gls - gls.max())
    return np.rint(np.minimum(pl, 9999)).astype(np.int64)


def genotype_sites(hap_events: list[list[VariantEvent]],
                   read_hap_logp: np.ndarray,
                   ploidy: int = 2) -> list[SiteCall]:
    """Call genotypes at every event site.

    hap_events: per-haplotype event lists (haplotype 0 = reference, []);
    read_hap_logp: (n_reads, n_haps) log10 likelihoods from PairHMM.
    """
    n_reads, n_haps = read_hap_logp.shape
    assert len(hap_events) == n_haps

    # group events by (pos, ref)
    sites: dict[tuple[int, str], list[str]] = {}
    for evs in hap_events:
        if evs is None:
            continue
        for e in evs:
            sites.setdefault((e.pos, e.ref), [])
            if e.alt not in sites[(e.pos, e.ref)]:
                sites[(e.pos, e.ref)].append(e.alt)

    calls: list[SiteCall] = []
    for (pos, ref), alts in sorted(sites.items()):
        alleles = [ref] + alts
        # haplotype support per allele
        support: list[list[int]] = [[] for _ in alleles]
        for h, evs in enumerate(hap_events):
            if evs is None:
                continue
            ev_here = [e for e in evs if e.pos == pos and e.ref == ref]
            if not ev_here:
                support[0].append(h)
            else:
                for e in ev_here:
                    ai = alleles.index(e.alt)
                    support[ai].append(h)
        # allele likelihood per read: max over supporting haps
        L = np.full((n_reads, len(alleles)), -300.0)
        for ai, hs in enumerate(support):
            if hs:
                L[:, ai] = read_hap_logp[:, hs].max(axis=1)
        informative = L.max(axis=1) > -300.0
        Li = L[informative]
        dp = int(informative.sum())
        if dp == 0:
            continue

        genotypes = list(
            itertools.combinations_with_replacement(range(len(alleles)),
                                                    ploidy))
        gls = np.zeros(len(genotypes))
        for gi, gt in enumerate(genotypes):
            # log10( mean_k 10^L(r|a_k) ), summed over reads
            stacked = Li[:, list(gt)]  # (dp, ploidy)
            m = stacked.max(axis=1)
            mean = (np.power(10.0, stacked - m[:, None]).mean(axis=1))
            gls[gi] = float((m + np.log10(mean)).sum())
        pls = _gl_to_pl(gls)
        best = int(np.argmin(pls))
        gt = genotypes[best]
        sorted_pls = np.sort(pls)
        gq = int(min(99, sorted_pls[1] - sorted_pls[0])) \
            if len(pls) > 1 else 99
        hom_ref_idx = genotypes.index(tuple([0] * ploidy))
        qual = float(pls[hom_ref_idx])
        # allelic depth: assign each informative read to its best allele
        best_allele = Li.argmax(axis=1)
        margin = Li.max(axis=1) - np.sort(Li, axis=1)[:, -2] \
            if Li.shape[1] > 1 else np.full(dp, 1.0)
        ad = [int(((best_allele == ai) & (margin > 0.1)).sum())
              for ai in range(len(alleles))]
        calls.append(SiteCall(pos, ref, alts, gt, pls.tolist(), gq, qual,
                              ad, dp))
    return calls


def site_to_vcf_record(call: SiteCall, contig: str, window_start: int,
                       sample_gq_floor: int = 0) -> VcfRecord:
    """SiteCall → VcfRecord (1-based global position)."""
    gt_str = "/".join(str(a) for a in sorted(call.gt))
    return VcfRecord(
        contig=contig,
        pos=window_start + call.pos + 1,
        ref=call.ref,
        alts=list(call.alts),
        qual=max(call.qual, float(sample_gq_floor)),
        filter="PASS" if call.qual > 0 else "LowQual",
        info={"DP": call.dp},
        fmt=["GT", "AD", "DP", "GQ", "PL"],
        samples=[{
            "GT": gt_str,
            "AD": call.ad,
            "DP": call.dp,
            "GQ": call.gq,
            "PL": call.pls,
        }])

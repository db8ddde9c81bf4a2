"""Record-level BAM/VCF equivalence gates.

The reference's acceptance tier (SURVEY.md §4 tier 3) shells out to
``bamUtil diff`` and ``rtg vcfeval``/GATK VariantEval
(scripts/compareBAM.sh:16-25, scripts/compareVCF.sh:121-159).  Neither
tool exists in this environment, so the same gates are provided
in-repo: record-keyed diffs with the pass rules the scripts encode
(compareBAM: 0 differing records; compareVCF: 0 non-concordant
variants).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class BamDiff:
    only_a: int = 0
    only_b: int = 0
    differing: int = 0      # same key, different alignment fields
    matching: int = 0

    @property
    def equivalent(self) -> bool:
        """compareBAM.sh pass rule: no differing records."""
        return self.only_a == self.only_b == self.differing == 0


def compare_bam(path_a: str, path_b: str,
                compare_tags: bool = False) -> BamDiff:
    """``bamUtil diff`` analog: records keyed by (qname, flag's
    read-number bits), compared on (tid, pos, mapq, flag, cigar, seq,
    qual).  Binary-identical files short-circuit like compareBAM.sh's
    ``diff`` fast path."""
    from pathlib import Path

    from ..io.bam import read_bam

    if Path(path_a).read_bytes() == Path(path_b).read_bytes():
        n = len(read_bam(path_a)[1])
        return BamDiff(matching=n)

    def index(path):
        _, recs = read_bam(path)
        out = {}
        for r in recs:
            out[(r.qname, r.flag & 0xC0, r.flag & 0x900)] = r
        return out

    a, b = index(path_a), index(path_b)
    diff = BamDiff()
    for key, ra in a.items():
        rb = b.get(key)
        if rb is None:
            diff.only_a += 1
            continue
        same = (ra.tid == rb.tid and ra.pos == rb.pos
                and ra.flag == rb.flag and ra.mapq == rb.mapq
                and ra.cigar == rb.cigar and ra.seq == rb.seq
                and ra.qual == rb.qual)
        if same and compare_tags:
            same = ra.tags == rb.tags
        if same:
            diff.matching += 1
        else:
            diff.differing += 1
    diff.only_b = len(b.keys() - a.keys())
    return diff


@dataclasses.dataclass
class VcfConcordance:
    concordant: int = 0
    discordant_gt: int = 0   # same site+alleles, different genotype
    only_a: int = 0
    only_b: int = 0

    @property
    def equivalent(self) -> bool:
        """compareVCF.sh pass rule: 0 extra (non-concordant) variants."""
        return self.only_a == self.only_b == self.discordant_gt == 0

    @property
    def concordance(self) -> float:
        total = (self.concordant + self.discordant_gt + self.only_a
                 + self.only_b)
        return self.concordant / total if total else 1.0


def compare_vcf(path_a: str, path_b: str) -> VcfConcordance:
    """vcfeval/VariantEval-CompOverlap analog: variant records keyed by
    (contig, pos, ref, alts); genotypes compared unordered (0/1 == 1/0).
    gVCF reference blocks are ignored on both sides."""
    from ..io.vcf import read_vcf

    def index(path):
        _, recs = read_vcf(path)
        out = {}
        for r in recs:
            if r.is_gvcf_block:
                continue
            alts = tuple(a for a in r.alts if a != "<NON_REF>")
            gts = tuple(
                tuple(sorted(str(s.get("GT", "./.")).replace("|", "/")
                             .split("/"))) for s in r.samples)
            out[(r.contig, r.pos, r.ref, alts)] = gts
        return out

    a, b = index(path_a), index(path_b)
    out = VcfConcordance()
    for key, ga in a.items():
        gb = b.get(key)
        if gb is None:
            out.only_a += 1
        elif ga == gb:
            out.concordant += 1
        else:
            out.discordant_gt += 1
    out.only_b = len(b.keys() - a.keys())
    return out

"""Simulated germline samples with planted truth, and the checks run on
them: call accuracy against the truth and record-level equivalence of
two pipeline runs.

The simulator makes, from one seed: a random single-contig genome; het
SNPs (about one per kb) and short indels (1-10 bp, half het, half hom);
two haplotypes; 150 bp read pairs with a normal insert size, a share of
duplicate fragments, and per-base qualities with substitution errors
drawn from them.  It writes ``ref.fa`` and gzip-free ``reads_1.fastq`` /
``reads_2.fastq`` and returns the truth.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from falcon_genome_tpu.io import native_ext
from falcon_genome_tpu.io.bam import read_bam_columns
from falcon_genome_tpu.io.dna import decode_seq
from falcon_genome_tpu.io.fasta import write_fasta
from falcon_genome_tpu.io.vcf import read_vcf
from falcon_genome_tpu.utils.compare import compare_bam, compare_vcf

_ASCII = np.frombuffer(b"ACGTN", np.uint8)


@dataclasses.dataclass
class Sample:
    ref: str
    fastq1: str
    fastq2: str
    n_pairs: int
    snps: dict[int, int]              # 0-based pos → alt code
    indels: list[tuple[int, str, str]]  # (1-based VCF pos, REF, ALT)


def host_extension_available() -> bool:
    """Whether the reference's fgio C++ host extension built here."""
    return native_ext.available()


def _write_fastq(path: Path, names: list[str], codes: np.ndarray,
                 quals: np.ndarray) -> None:
    seq = _ASCII[codes]
    qual = (quals + 33).astype(np.uint8)
    with open(path, "wb") as f:
        for i, name in enumerate(names):
            f.write(b"@" + name.encode() + b"\n" + seq[i].tobytes()
                    + b"\n+\n" + qual[i].tobytes() + b"\n")


def simulate_sample(out_dir, genome_len: int, coverage: float, seed: int,
                    read_len: int = 150, insert_mean: int = 350,
                    insert_sd: int = 30, snp_per_kb: float = 1.0,
                    n_indels: int = 100, error_rate: float = 0.005,
                    dup_frac: float = 0.05, contig: str = "chr1") -> Sample:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len).astype(np.uint8)

    # variant sites at least 30 bp apart and 500 bp from the ends
    n_snp = int(genome_len * snp_per_kb / 1000)
    cand = np.sort(rng.choice(np.arange(500, genome_len - 500),
                              size=n_snp + n_indels + 200, replace=False))
    keep = np.concatenate([[True], np.diff(cand) >= 30])
    cand = rng.permutation(cand[keep])
    snp_pos = np.sort(cand[:n_snp])
    indel_pos = np.sort(cand[n_snp:n_snp + n_indels])

    # per haplotype: list of (pos, ref_len, alt codes) edits
    edits: list[list[tuple[int, int, np.ndarray]]] = [[], []]
    snps: dict[int, int] = {}
    for p in snp_pos:
        alt = (int(genome[p]) + int(rng.integers(1, 4))) % 4
        snps[int(p)] = alt
        edits[int(rng.integers(0, 2))].append(
            (int(p), 1, np.array([alt], np.uint8)))
    indels: list[tuple[int, str, str]] = []
    for k, p in enumerate(indel_pos):
        p = int(p)
        L = int(rng.integers(1, 11))
        if k % 2:                                   # deletion after p
            ref_s = genome[p:p + 1 + L]
            alt_s = genome[p:p + 1]
        else:                                       # insertion after p
            ref_s = genome[p:p + 1]
            alt_s = np.concatenate([genome[p:p + 1],
                                    rng.integers(0, 4, L).astype(np.uint8)])
        indels.append((p + 1, decode_seq(ref_s), decode_seq(alt_s)))
        for h in ((0, 1) if k % 4 < 2 else (int(rng.integers(0, 2)),)):
            edits[h].append((p, len(ref_s), alt_s))
    haps = []
    for h in range(2):
        parts, at = [], 0
        for p, rlen, alt in sorted(edits[h], key=lambda e: e[0]):
            parts.append(genome[at:p])
            parts.append(alt)
            at = p + rlen
        parts.append(genome[at:])
        haps.append(np.concatenate(parts))

    # fragments: a share of them duplicates of earlier ones
    n_pairs = int(coverage * genome_len / (2 * read_len))
    n_uniq = int(n_pairs * (1 - dup_frac))
    hap_of = rng.integers(0, 2, n_uniq)
    ins = np.clip(np.rint(rng.normal(insert_mean, insert_sd, n_uniq)),
                  read_len, 2 * insert_mean).astype(np.int64)
    start = (rng.random(n_uniq)
             * (np.array([len(haps[h]) for h in hap_of]) - ins)).astype(
        np.int64)
    flip = rng.random(n_uniq) < 0.5
    dup = rng.integers(0, n_uniq, n_pairs - n_uniq)
    hap_of, ins, start, flip = (np.concatenate([a, a[dup]])
                                for a in (hap_of, ins, start, flip))
    order = rng.permutation(n_pairs)
    hap_of, ins, start, flip = (a[order] for a in (hap_of, ins, start, flip))

    offs = np.arange(read_len)
    r1 = np.empty((n_pairs, read_len), np.uint8)
    r2 = np.empty((n_pairs, read_len), np.uint8)
    for h in range(2):
        m = hap_of == h
        left = haps[h][start[m, None] + offs]
        right = haps[h][(start[m] + ins[m] - read_len)[:, None] + offs]
        right = (3 - right[:, ::-1]).astype(np.uint8)   # reverse strand
        f = flip[m, None]
        r1[m] = np.where(f, right, left)
        r2[m] = np.where(f, left, right)

    def sequence(reads):
        # qualities 20-40 falling along the read; substitutions drawn at a
        # rate proportional to the quality's error probability
        q = np.clip(40 - (offs[None, :] * 12) // read_len
                    - rng.integers(0, 10, reads.shape), 2, 41)
        p = 10.0 ** (-q / 10.0)
        p *= error_rate / p.mean()
        err = rng.random(reads.shape) < p
        reads = np.where(err, (reads + rng.integers(1, 4, reads.shape)) % 4,
                         reads).astype(np.uint8)
        return reads, q.astype(np.uint8)

    (r1, q1), (r2, q2) = sequence(r1), sequence(r2)
    names = [f"sim{i}" for i in range(n_pairs)]
    write_fasta(out / "ref.fa", {contig: decode_seq(genome)})
    _write_fastq(out / "reads_1.fastq", names, r1, q1)
    _write_fastq(out / "reads_2.fastq", names, r2, q2)
    return Sample(str(out / "ref.fa"), str(out / "reads_1.fastq"),
                  str(out / "reads_2.fastq"), n_pairs, snps, indels)


def score_calls(vcf_path: str, sample: Sample) -> dict[str, float]:
    """SNP/indel sensitivity and precision of a VCF against the truth.

    A SNP call is right when its position and alt allele match; an indel
    call is right when a truth indel of the same type and length lies
    within 10 bp (callers may place an indel anywhere in a repeat)."""
    _, recs = read_vcf(vcf_path)
    calls = [r for r in recs if not r.is_gvcf_block
             and any(a not in ("<NON_REF>", ".") for a in r.alts)]
    snp_hit, indel_hit = set(), set()
    good = 0
    truth_indels = [(p, len(a) - len(r)) for p, r, a in sample.indels]
    for r in calls:
        alt = r.alts[0]
        if len(r.ref) == 1 and len(alt) == 1:
            code = "ACGT".find(alt)
            if sample.snps.get(r.pos - 1) == code:
                snp_hit.add(r.pos - 1)
                good += 1
            continue
        delta = len(alt) - len(r.ref)
        for k, (p, d) in enumerate(truth_indels):
            if d == delta and abs(p - r.pos) <= 10:
                indel_hit.add(k)
                good += 1
                break
    return dict(
        n_calls=len(calls),
        snp_sensitivity=len(snp_hit) / max(1, len(sample.snps)),
        indel_sensitivity=len(indel_hit) / max(1, len(sample.indels)),
        precision=good / max(1, len(calls)))


def bam_covariates(bam_path: str, ref_path: str):
    """A BAM's record columns and BQSR covariates (no known sites), as
    ``baserecal`` extracts them: ``(columns, covariates, read_groups)``."""
    from .bqsr import extract_covariates_columns
    from .stages.common import load_fasta
    header, cols = read_bam_columns(bam_path)
    fa = load_fasta(ref_path)
    ref_by_tid = {i: fa.contig_codes(name)
                  for i, (name, _) in enumerate(header.contigs)}
    rgs = [rg["ID"] for rg in header.read_groups] or ["default"]
    covs = extract_covariates_columns(cols, ref_by_tid, None,
                                      {g: i for i, g in enumerate(rgs)})
    return cols, covs, rgs


def vcf_records(path: str) -> list[tuple]:
    """A VCF's records as comparable tuples (contig, pos, ref, alts,
    qual, samples)."""
    _, recs = read_vcf(path)
    return [(r.contig, r.pos, r.ref, tuple(r.alts), r.qual, r.samples)
            for r in recs]


def compare_runs(work_a: str, work_b: str, vcf_a: str, vcf_b: str
                 ) -> dict[str, object]:
    """Record-level equivalence of two germline runs' aligned bucket
    BAMs, deduplicated BAM, recalibrated part BAMs and VCFs."""
    wa, wb = Path(work_a), Path(work_b)
    bam = {}
    for sub in ("aligned", "recal"):
        pa = sorted(p.name for p in (wa / sub).glob("part-*.bam"))
        pb = sorted(p.name for p in (wb / sub).glob("part-*.bam"))
        same = pa == pb
        n = 0
        for name in pa if same else []:
            d = compare_bam(str(wa / sub / name), str(wb / sub / name),
                            compare_tags=True)
            same &= d.equivalent
            n += d.matching
        bam[sub] = (same, n)
    d = compare_bam(str(wa / "dedup.bam"), str(wb / "dedup.bam"),
                    compare_tags=True)
    bam["dedup"] = (d.equivalent, d.matching)
    c = compare_vcf(vcf_a, vcf_b)
    return dict(bam=bam, vcf_equivalent=c.equivalent,
                vcf_concordant=c.concordant,
                vcf_non_concordant=c.only_a + c.only_b + c.discordant_gt)

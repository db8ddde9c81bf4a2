"""Simulated germline samples with planted truth, and the checks run on
them: call accuracy against the truth and record-level equivalence of
two pipeline runs.

The simulator makes, from one seed: a random single-contig genome; het
SNPs (about one per kb) and short indels (1-10 bp, half het, half hom);
two haplotypes; 150 bp read pairs with a normal insert size, a share of
duplicate fragments, and per-base qualities with substitution errors
drawn from them.  It writes ``ref.fa`` and gzip-free ``reads_1.fastq`` /
``reads_2.fastq`` and returns the truth.  :func:`simulate_tumor_normal`
makes a normal and a tumor sample from one such genome, the tumor with
somatic SNVs of its own at a given allele fraction.
:func:`simulate_long_reads` makes ONT-class long reads of a random genome
(optionally with het SNVs), with each read's true start and strand.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from .io import native_ext
from .io.bam import read_bam_columns
from .io.dna import decode_seq
from .io.fasta import write_fasta
from .io.vcf import read_vcf
from .utils.compare import compare_bam, compare_vcf

_ASCII = np.frombuffer(b"ACGTN", np.uint8)


@dataclasses.dataclass
class Sample:
    ref: str
    fastq1: str
    fastq2: str
    n_pairs: int
    snps: dict[int, int]              # 0-based pos → alt code
    indels: list[tuple[int, str, str]]  # (1-based VCF pos, REF, ALT)


@dataclasses.dataclass
class Reads:
    fastq1: str
    fastq2: str
    n_pairs: int


@dataclasses.dataclass
class TumorNormal:
    ref: str
    tumor: Reads
    normal: Reads
    snps: dict[int, int]              # germline: 0-based pos → alt code
    indels: list[tuple[int, str, str]]  # germline (1-based VCF pos, REF, ALT)
    somatic: dict[int, int]           # tumor only: 0-based pos → alt code


@dataclasses.dataclass
class LongReads:
    ref: str
    fastq: str
    n_reads: int
    n_bases: int
    truth: list[tuple[int, bool]]     # read lr<i>: (0-based start, reverse)
    snps: dict[int, int]              # het SNVs: 0-based pos → alt code
    indels: list[tuple[int, str, str]]  # none planted (for score_calls)


def host_extension_available() -> bool:
    """Whether the fgio C++ host extension (``native/``) built here."""
    return native_ext.available()


def _write_fastq(path: Path, names: list[str], codes: np.ndarray,
                 quals: np.ndarray) -> None:
    seq = _ASCII[codes]
    qual = (quals + 33).astype(np.uint8)
    with open(path, "wb") as f:
        for i, name in enumerate(names):
            f.write(b"@" + name.encode() + b"\n" + seq[i].tobytes()
                    + b"\n+\n" + qual[i].tobytes() + b"\n")


def _germline(rng, genome_len: int, snp_per_kb: float, n_indels: int,
              n_other: int = 0):
    """A random genome with het SNPs (``snp_per_kb``) and short indels
    (1-10 bp, half het, half hom), all at least 30 bp apart and 500 bp
    from the ends: (genome, per-haplotype edits, snps, indels, other
    sites).  ``n_other`` more sites, as far from the variants, are drawn
    for the caller to use."""
    genome = rng.integers(0, 4, genome_len).astype(np.uint8)
    n_snp = int(genome_len * snp_per_kb / 1000)
    cand = np.sort(rng.choice(np.arange(500, genome_len - 500),
                              size=n_snp + n_indels + n_other + 200,
                              replace=False))
    keep = np.concatenate([[True], np.diff(cand) >= 30])
    cand = rng.permutation(cand[keep])
    snp_pos = np.sort(cand[:n_snp])
    indel_pos = np.sort(cand[n_snp:n_snp + n_indels])
    other = np.sort(cand[n_snp + n_indels:n_snp + n_indels + n_other])

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
    return genome, edits, snps, indels, other


def _apply(genome: np.ndarray, edits) -> np.ndarray:
    """The haplotype that carries ``edits`` (pos, ref_len, alt codes)."""
    parts, at = [], 0
    for p, rlen, alt in sorted(edits, key=lambda e: e[0]):
        parts.append(genome[at:p])
        parts.append(alt)
        at = p + rlen
    parts.append(genome[at:])
    return np.concatenate(parts)


def _reads(rng, out: Path, stem: str, prefix: str, haps: list[np.ndarray],
           hap_p: np.ndarray | None, coverage: float, genome_len: int,
           read_len: int, insert_mean: int, insert_sd: int,
           error_rate: float, dup_frac: float) -> tuple[str, str, int]:
    """Read pairs from ``haps`` (drawn uniformly from the first two, or
    by ``hap_p``) with a normal insert size, a share of duplicate
    fragments, and per-base qualities with substitution errors drawn from
    them; written as ``<stem>_1.fastq`` / ``<stem>_2.fastq``, the reads
    named ``<prefix><i>``."""
    n_pairs = int(coverage * genome_len / (2 * read_len))
    n_uniq = int(n_pairs * (1 - dup_frac))
    hap_of = (rng.integers(0, 2, n_uniq) if hap_p is None
              else rng.choice(len(haps), n_uniq, p=hap_p))
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
    for h in range(len(haps)):
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
    names = [f"{prefix}{i}" for i in range(n_pairs)]
    fq1, fq2 = out / f"{stem}_1.fastq", out / f"{stem}_2.fastq"
    _write_fastq(fq1, names, r1, q1)
    _write_fastq(fq2, names, r2, q2)
    return str(fq1), str(fq2), n_pairs


def simulate_sample(out_dir, genome_len: int, coverage: float, seed: int,
                    read_len: int = 150, insert_mean: int = 350,
                    insert_sd: int = 30, snp_per_kb: float = 1.0,
                    n_indels: int = 100, error_rate: float = 0.005,
                    dup_frac: float = 0.05, contig: str = "chr1") -> Sample:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    genome, edits, snps, indels, _ = _germline(rng, genome_len, snp_per_kb,
                                               n_indels)
    haps = [_apply(genome, e) for e in edits]
    write_fasta(out / "ref.fa", {contig: decode_seq(genome)})
    fq1, fq2, n_pairs = _reads(rng, out, "reads", "sim", haps, None,
                               coverage, genome_len, read_len, insert_mean,
                               insert_sd, error_rate, dup_frac)
    return Sample(str(out / "ref.fa"), fq1, fq2, n_pairs, snps, indels)


def simulate_tumor_normal(out_dir, genome_len: int, seed: int,
                          normal_coverage: float = 30.0,
                          tumor_coverage: float = 60.0,
                          somatic_per_kb: float = 0.2,
                          somatic_af: float = 0.3, read_len: int = 150,
                          insert_mean: int = 350, insert_sd: int = 30,
                          snp_per_kb: float = 1.0, n_indels: int = 100,
                          error_rate: float = 0.005, dup_frac: float = 0.05,
                          contig: str = "chr1") -> TumorNormal:
    """A tumor/normal pair over one genome: the germline variants of
    :func:`simulate_sample` in both samples, and somatic SNVs
    (``somatic_per_kb``, at least 30 bp from every other variant) in the
    tumor only, each on one haplotype, carried by a share ``2 *
    somatic_af`` of that haplotype's tumor fragments, so that its allele
    fraction is ``somatic_af``.  Writes ``ref.fa``, ``normal_{1,2}.fastq``
    and ``tumor_{1,2}.fastq``."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    n_som = int(genome_len * somatic_per_kb / 1000)
    genome, edits, snps, indels, som_pos = _germline(
        rng, genome_len, snp_per_kb, n_indels, n_som)
    somatic: dict[int, int] = {}
    som_edits: list[list] = [list(edits[0]), list(edits[1])]
    for p in som_pos:
        alt = (int(genome[p]) + int(rng.integers(1, 4))) % 4
        somatic[int(p)] = alt
        som_edits[int(rng.integers(0, 2))].append(
            (int(p), 1, np.array([alt], np.uint8)))
    haps = [_apply(genome, e) for e in edits + som_edits]
    write_fasta(out / "ref.fa", {contig: decode_seq(genome)})
    common = (genome_len, read_len, insert_mean, insert_sd, error_rate,
              dup_frac)
    normal = _reads(rng, out, "normal", "normal", haps[:2], None,
                    normal_coverage, *common)
    carried = 2 * somatic_af
    tumor = _reads(rng, out, "tumor", "tumor", haps,
                   np.array([1 - carried, 1 - carried, carried, carried])
                   / 2, tumor_coverage, *common)
    return TumorNormal(str(out / "ref.fa"), Reads(*tumor), Reads(*normal),
                       snps, indels, somatic)


def simulate_long_reads(out_dir, genome_len: int, coverage: float,
                        seed: int, median: int = 10_000, sigma: float = 0.45,
                        min_len: int = 3_000, max_len: int = 30_000,
                        n_snps: int = 0, error_rate: float = 0.05,
                        insertions: bool = False,
                        contig: str = "chr1") -> LongReads:
    """ONT-class reads of a random genome: lengths log-normal around
    ``median`` (``sigma`` of the log) clipped to [min_len, max_len], errors
    at ``error_rate`` (60% substitutions, 40% deletions; with
    ``insertions`` a third each of insertions, deletions and
    substitutions, the profile of the reference's long-read tests),
    either strand at random, starts uniform, until the bases reach
    ``coverage`` x the genome.  With ``n_snps`` het SNVs (at least 100 bp
    apart, 1 kb from the ends) each read comes from either haplotype with
    equal chance.  Writes ``ref.fa`` and ``long_reads.fastq`` (quality
    40)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len).astype(np.uint8)
    sites = np.arange(1000, genome_len - 1000, 100)
    snp_pos = np.sort(rng.choice(sites, n_snps, replace=False))
    alt = (genome[snp_pos] + rng.integers(1, 4, n_snps)) % 4
    hap = genome.copy()
    hap[snp_pos] = alt
    write_fasta(out / "ref.fa", {contig: decode_seq(genome)})
    truth, names, seqs, total = [], [], [], 0
    while total < coverage * genome_len:
        L = int(np.clip(median * np.exp(sigma * rng.standard_normal()),
                        min_len, min(max_len, genome_len - 1)))
        p = int(rng.integers(0, genome_len - L))
        r = (hap if n_snps and rng.random() < 0.5 else genome)[p:p + L]
        u = rng.random(L)
        if insertions:      # a random base before base i, base i kept
            ins = u < error_rate / 3
            dele = (u >= error_rate / 3) & (u < 2 * error_rate / 3)
            sub = (u >= 2 * error_rate / 3) & (u < error_rate)
            r = np.where(sub, (r + rng.integers(1, 4, L)) % 4, r)[~dele]
            at = np.flatnonzero(ins[~dele])
            r = np.insert(r, at, rng.integers(0, 4, len(at)))
        else:
            sub = rng.random(L) < 0.6
            r = np.where((u < error_rate) & sub, (r + 1) % 4,
                         r)[~((u < error_rate) & ~sub)]
        rev = bool(rng.random() < 0.5)
        if rev:
            r = (3 - r[::-1]).astype(np.uint8)
        names.append(f"lr{len(truth)}")
        seqs.append(r.astype(np.uint8))
        truth.append((p, rev))
        total += len(r)
    fq = out / "long_reads.fastq"
    with open(fq, "wb") as f:
        for name, r in zip(names, seqs):
            f.write(b"@" + name.encode() + b"\n" + _ASCII[r].tobytes()
                    + b"\n+\n" + b"I" * len(r) + b"\n")
    return LongReads(str(out / "ref.fa"), str(fq), len(truth), total, truth,
                     dict(zip(snp_pos.tolist(), alt.tolist())), [])


def score_long_alignments(bam_path: str, reads: LongReads
                          ) -> dict[str, float]:
    """The share of reads mapped, and of mapped reads placed within 100 bp
    of their true start on the right strand."""
    from .io.bam import read_bam
    _, recs = read_bam(bam_path)
    mapped = placed = 0
    for r in recs:
        if r.is_unmapped:
            continue
        mapped += 1
        pos, rev = reads.truth[int(r.qname[2:])]
        placed += abs(r.pos - pos) < 100 and r.is_reverse == rev
    return dict(n_records=len(recs), mapped=mapped / reads.n_reads,
                placed=placed / max(1, mapped))


def score_calls(vcf_path: str, sample: Sample | LongReads
                ) -> dict[str, float]:
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


def score_somatic(vcf_path: str, tn: TumorNormal) -> dict[str, float]:
    """Somatic SNV sensitivity and precision of a ``mutect2`` VCF against
    the planted truth, over the records with ``FILTER=PASS``; and how many
    records lie at a germline variant site (a SNP's position, or within
    10 bp of an indel), in all and with ``FILTER=PASS``."""
    _, recs = read_vcf(vcf_path)
    passed = [r for r in recs if r.filter == "PASS"]
    hit = {r.pos - 1 for r in passed
           if len(r.ref) == 1 and len(r.alts[0]) == 1
           and tn.somatic.get(r.pos - 1) == "ACGT".find(r.alts[0])}
    indel_pos = np.array(sorted(p for p, _, _ in tn.indels), np.int64)

    def germline(r) -> bool:
        near = (indel_pos.size and
                np.abs(indel_pos - r.pos).min() <= 10)
        return (r.pos - 1) in tn.snps or bool(near)
    return dict(
        n_records=len(recs), n_pass=len(passed),
        n_somatic=len(tn.somatic),
        somatic_sensitivity=len(hit) / max(1, len(tn.somatic)),
        somatic_precision=len(hit) / max(1, len(passed)),
        germline_sites_emitted=sum(germline(r) for r in recs),
        germline_sites_pass=sum(germline(r) for r in passed))


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

"""Mutect2-class somatic tumor/normal calling + FilterMutectCalls analog.

Reference surface: Mutect2Worker (SURVEY.md §2 row 15,
src/workers/Mutect2Worker.cpp — GATK4 path with ``-normal/-tumor``) and
Mutect2FilterWorker (row 16).  The machinery is shared with the
HaplotypeCaller (assembly, the hap→ref Smith-Waterman and PairHMM device
batches); the genotyping model is the somatic likelihood-ratio test:

* TLOD: log10 LR of "allele present in tumor at fraction f̂" vs "absent",
  with f̂ the MLE allele fraction from read assignments;
* NLOD: log10 LR of "normal is homozygous reference" vs "allele present
  as a germline het" — high NLOD means the normal supports the site being
  somatic rather than germline.

Emission thresholds follow GATK4 defaults (TLOD ≥ 5.3 at emit,
NLOD ≥ 2.2 for germline rejection when a normal is present).

Port of ``falcon_genome_tpu/models/mutect2.py``: the device batches run on
``Mutect2Params.device``; the resource tables and the filter are host
code.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import DEFAULT_DEVICE
from ..io.sam import SamRecord
from ..io.vcf import VcfRecord
from .activeregion import ActiveRegionParams, find_active_regions
from .assembly import AssemblyParams, assemble_region
from .haplotypecaller import (
    _hap_to_ref_events, clip_read, clip_read_to_region,
    read_hap_likelihood_matrix)

TLOD_THRESHOLD = 5.3
NLOD_THRESHOLD = 2.2


@dataclasses.dataclass
class Mutect2Params:
    active: ActiveRegionParams = dataclasses.field(
        default_factory=lambda: ActiveRegionParams(threshold=0.01))
    assembly: AssemblyParams = dataclasses.field(
        default_factory=lambda: AssemblyParams(min_edge_mult=1))
    max_reads_per_region: int = 384
    min_mapq: int = 10
    tlod_threshold: float = TLOD_THRESHOLD
    nlod_threshold: float = NLOD_THRESHOLD
    tumor_sample: str = "TUMOR"
    normal_sample: str = "NORMAL"
    gcp: int = 10
    device: torch.device = DEFAULT_DEVICE   # SW + PairHMM batches


def _allele_likelihoods(hap_events, logp: np.ndarray, pos: int, ref: str,
                        alt: str, span_lo: np.ndarray | None = None,
                        span_hi: np.ndarray | None = None
                        ) -> tuple[np.ndarray, np.ndarray]:
    """(L_ref, L_alt) per read for one site (log10).

    ``span_lo``/``span_hi`` are per-read region-relative alignment spans:
    reads that do NOT overlap ``pos`` are neutralised (L_alt := L_ref),
    GATK's overlap-based AlleleLikelihoods marginalisation.  Without
    this, a read that never sees the candidate site but shares some
    OTHER event with only one haplotype group votes for that group —
    with combinatorial error haplotypes this inflated TLOD enough to
    pass single-error-read sites (round-4 mutect2 rehearsal FPs)."""
    ref_haps = [h for h, evs in enumerate(hap_events)
                if evs is not None and not any(
                    e.pos == pos and e.ref == ref for e in evs)]
    alt_haps = [h for h, evs in enumerate(hap_events)
                if evs is not None and any(
                    e.pos == pos and e.ref == ref and e.alt == alt
                    for e in evs)]
    L_ref = (logp[:, ref_haps].max(axis=1) if ref_haps
             else np.full(logp.shape[0], -300.0))
    L_alt = (logp[:, alt_haps].max(axis=1) if alt_haps
             else np.full(logp.shape[0], -300.0))
    if span_lo is not None:
        overlaps = (span_lo <= pos) & (pos < span_hi)
        L_alt = np.where(overlaps, L_alt, L_ref)
    return L_ref, L_alt


def _mixture_loglik(L_ref: np.ndarray, L_alt: np.ndarray, f: float
                    ) -> float:
    """Σ_r log10((1-f)·10^Lref + f·10^Lalt), stable."""
    m = np.maximum(L_ref, L_alt)
    val = (1 - f) * np.power(10.0, L_ref - m) + \
        f * np.power(10.0, L_alt - m)
    return float((m + np.log10(np.maximum(val, 1e-300))).sum())


def _tlod(L_ref: np.ndarray, L_alt: np.ndarray) -> tuple[float, float]:
    """(TLOD, f̂): LR of best-f mixture vs f≈0."""
    if len(L_ref) == 0:
        return 0.0, 0.0
    support = (L_alt - L_ref) > 0.3
    informative = np.abs(L_alt - L_ref) > 0.3
    denom = max(1, int(informative.sum()))
    f_hat = float(np.clip(support.sum() / denom, 1e-3, 1.0))
    ll_alt = _mixture_loglik(L_ref, L_alt, f_hat)
    ll_null = _mixture_loglik(L_ref, L_alt, 0.0)
    return ll_alt - ll_null, f_hat


def _nlod(L_ref: np.ndarray, L_alt: np.ndarray) -> float:
    """LR of 'normal hom-ref' vs 'germline het in normal'."""
    if len(L_ref) == 0:
        return 0.0
    ll_ref = _mixture_loglik(L_ref, L_alt, 0.0)
    ll_het = _mixture_loglik(L_ref, L_alt, 0.5)
    return ll_ref - ll_het


class Mutect2:
    def __init__(self, params: Mutect2Params = None):
        self.params = params or Mutect2Params()

    def call_region(self, tumor: list[SamRecord],
                    normal: list[SamRecord] | None,
                    ref: np.ndarray, contig: str, rstart: int, rend: int
                    ) -> list[VcfRecord]:
        from ..io.dna import encode_seq

        p = self.params
        region_ref = ref[rstart:rend]

        def usable(recs):
            out = [r for r in recs
                   if not r.is_unmapped and not r.is_duplicate
                   and not (r.flag & 0x900) and r.mapq >= p.min_mapq
                   and r.pos < rend and r.end_pos > rstart
                   and r.seq not in ("*", "")]
            return out[:p.max_reads_per_region]

        t_reads = usable(tumor)
        n_reads = usable(normal) if normal else []
        if not t_reads:
            return []

        # assembly over tumor+normal reads so germline haps are present
        all_codes = [
            encode_seq(s) for s, _ in
            (clip_read_to_region(r, rstart, rend)
             for r in t_reads + n_reads) if s]
        asm = assemble_region(region_ref, all_codes, p.assembly)
        haps = asm.haplotypes
        if len(haps) == 1:
            return []
        hap_events = _hap_to_ref_events(haps, region_ref, p.device)

        logp_t, _ = read_hap_likelihood_matrix(t_reads, haps, rstart, rend,
                                               p.gcp, p.device)
        logp_n = (read_hap_likelihood_matrix(n_reads, haps, rstart, rend,
                                             p.gcp, p.device)[0]
                  if n_reads else None)

        return self._genotype_somatic(hap_events, logp_t, logp_n,
                                      len(t_reads), contig, rstart,
                                      t_reads=t_reads, n_reads=n_reads)

    def _genotype_somatic(self, hap_events, logp_t, logp_n,
                          n_tumor: int, contig: str, rstart: int,
                          t_reads: list[SamRecord] | None = None,
                          n_reads: list[SamRecord] | None = None
                          ) -> list[VcfRecord]:
        p = self.params
        # per-tumor-read strand + pair orientation (for the strand-bias and
        # orientation-artifact filters; GATK SB / F1R2-F2R1 annotations)
        t_rev = t_f1r2 = None
        t_lo = t_hi = n_lo = n_hi = None
        if t_reads is not None:
            t_rev = np.array([r.is_reverse for r in t_reads], bool)
            read2 = np.array([bool(r.flag & 0x80) for r in t_reads], bool)
            t_f1r2 = t_rev == read2      # F1R2: R1 fwd, or R2 rev
            t_lo = np.array([r.pos - rstart for r in t_reads], np.int64)
            t_hi = np.array([r.end_pos - rstart for r in t_reads],
                            np.int64)
        if n_reads:
            n_lo = np.array([r.pos - rstart for r in n_reads], np.int64)
            n_hi = np.array([r.end_pos - rstart for r in n_reads],
                            np.int64)
        # candidate somatic events = union of events on assembled haps
        sites: dict[tuple[int, str], set[str]] = {}
        for evs in hap_events:
            if not evs:
                continue
            for e in evs:
                sites.setdefault((e.pos, e.ref), set()).add(e.alt)

        out: list[VcfRecord] = []
        for (pos, refa), alts in sorted(sites.items()):
            for alt in sorted(alts):
                Lr_t, La_t = _allele_likelihoods(hap_events, logp_t, pos,
                                                 refa, alt, t_lo, t_hi)
                tlod, f_hat = _tlod(Lr_t, La_t)
                if tlod < p.tlod_threshold:
                    continue
                nlod = None
                if logp_n is not None:
                    Lr_n, La_n = _allele_likelihoods(hap_events, logp_n,
                                                     pos, refa, alt,
                                                     n_lo, n_hi)
                    nlod = _nlod(Lr_n, La_n)
                    if nlod < p.nlod_threshold:
                        continue  # likely germline
                alt_mask = (La_t - Lr_t) > 0.3
                ref_mask = (Lr_t - La_t) > 0.3
                t_alt = int(alt_mask.sum())
                t_ref = int(ref_mask.sum())
                info = {"TLOD": round(tlod, 2), "DP": n_tumor}
                samples = [{
                    "GT": "0/1", "AD": [t_ref, t_alt],
                    "AF": round(f_hat, 3), "DP": t_ref + t_alt}]
                fmt = ["GT", "AD", "AF", "DP"]
                if t_rev is not None:
                    sb = [int((ref_mask & ~t_rev).sum()),
                          int((ref_mask & t_rev).sum()),
                          int((alt_mask & ~t_rev).sum()),
                          int((alt_mask & t_rev).sum())]
                    samples[0]["SB"] = sb
                    fmt = fmt + ["SB"]
                    info["F1R2"] = int((alt_mask & t_f1r2).sum())
                    info["F2R1"] = int((alt_mask & ~t_f1r2).sum())
                if nlod is not None:
                    info["NLOD"] = round(nlod, 2)
                    n_alt = int(((La_n - Lr_n) > 0.3).sum())
                    n_ref = int(((Lr_n - La_n) > 0.3).sum())
                    samples.append({
                        "GT": "0/0", "AD": [n_ref, n_alt],
                        "AF": round(n_alt / max(1, n_ref + n_alt), 3),
                        "DP": n_ref + n_alt})
                out.append(VcfRecord(
                    contig=contig, pos=rstart + pos + 1, ref=refa,
                    alts=[alt], qual=None, filter=".",
                    info=info, fmt=fmt, samples=samples))
        return out

    def call_interval(self, tumor: list[SamRecord],
                      normal: list[SamRecord] | None,
                      ref: np.ndarray, contig: str, start: int, end: int,
                      emit_start: int | None = None,
                      emit_end: int | None = None) -> list[VcfRecord]:
        """Batched like the HaplotypeCaller: one SW call and one PairHMM
        call per interval, covering every staged region's tumor+normal
        reads (tumor rows first per region, split after)."""
        from .haplotypecaller import (
            _hap_to_ref_events_multi, _likelihoods_multi)

        p = self.params
        regions = find_active_regions(tumor, ref, start, end, p.active)

        # region→read selection via the indexed selector (one vectorized
        # pass + per-region binary search); the per-region `for r in
        # recs` rescan was O(regions × records) — 20M+ end_pos calls
        # per WGS shard, 75% of the mutect2 wall
        from .haplotypecaller import ReadSelector
        t_sel = ReadSelector(tumor, p.min_mapq) if tumor else None
        n_sel = ReadSelector(normal, p.min_mapq) if normal else None

        staged = []
        for rstart, rend in regions:
            t_reads = (t_sel(rstart, rend, p.max_reads_per_region)
                       if t_sel is not None else [])
            if not t_reads:
                continue
            n_reads = (n_sel(rstart, rend, p.max_reads_per_region)
                       if n_sel is not None else [])
            region_ref = ref[rstart:rend]
            clipped = [clip_read(rec, rstart, rend)
                       for rec in t_reads + n_reads]
            asm = assemble_region(region_ref,
                                  [c for c, *_ in clipped if len(c)],
                                  p.assembly)
            if len(asm.haplotypes) == 1:
                continue
            staged.append(dict(rstart=rstart, rend=rend,
                               reads=t_reads + n_reads,
                               n_tumor=len(t_reads), clipped=clipped,
                               region_ref=region_ref,
                               haps=asm.haplotypes))

        out: list[VcfRecord] = []
        seen = set()
        if staged:
            hap_events_all = _hap_to_ref_events_multi(
                [(s["haps"], s["region_ref"]) for s in staged], p.device)
            logp_all = _likelihoods_multi(staged, p.gcp, p.device)
            for s, hap_events, logp in zip(staged, hap_events_all,
                                           logp_all):
                nt = s["n_tumor"]
                logp_t = logp[:nt]
                logp_n = logp[nt:] if len(logp) > nt and normal else None
                for rec in self._genotype_somatic(
                        hap_events, logp_t, logp_n, nt, contig,
                        s["rstart"], t_reads=s["reads"][:nt]):
                    key = (rec.pos, rec.ref, tuple(rec.alts))
                    if key not in seen:
                        seen.add(key)
                        out.append(rec)
        out.sort(key=lambda r: r.pos)
        if emit_start is not None or emit_end is not None:
            e0 = start if emit_start is None else emit_start
            e1 = end if emit_end is None else emit_end
            out = [r for r in out if e0 <= r.pos - 1 < e1]
        return out


# ---------------------------------------------------------------------------
# somatic resource inputs (ref Mutect2Worker.cpp:124-168: panel-of-normals,
# germline resource, dbsnp/cosmic; Mutect2FilterWorker.cpp:66-68:
# contamination table)
# ---------------------------------------------------------------------------

class SiteTable:
    """Positional lookup over a resource VCF (PoN / germline AF / dbsnp).

    Tabix-indexed ``.vcf.gz`` inputs stream per-region (bounded memory at
    WGS scale); plain VCFs load once.  Lookups key on (contig, pos, ref,
    alt) with a position-level fallback."""

    def __init__(self, path: str):
        from pathlib import Path as _P

        from ..utils.common import check_input
        self.path = check_input(path)
        self.indexed = (str(path).endswith(".gz")
                        and _P(str(path) + ".tbi").exists())
        self._all: dict[str, list] | None = None
        if not self.indexed:
            from ..io.vcf import read_vcf
            _, recs = read_vcf(self.path)
            self._all = {}
            for r in recs:
                self._all.setdefault(r.contig, []).append(r)

    def records(self, contig: str, start: int, end: int) -> list:
        """Resource records with pos in [start, end) (0-based half-open)."""
        if self.indexed:
            from ..io.tabix import query_vcf_region
            # query takes 1-based inclusive coordinates
            return [r for r in query_vcf_region(self.path, contig,
                                                start + 1, end)
                    if start <= r.pos - 1 < end]
        return [r for r in self._all.get(contig, ())
                if start <= r.pos - 1 < end]


@dataclasses.dataclass
class SomaticResources:
    """The reference's Mutect2 resource surface, as site tables."""
    pon: SiteTable | None = None
    germline: SiteTable | None = None
    dbsnp: list[SiteTable] = dataclasses.field(default_factory=list)
    cosmic: list[SiteTable] = dataclasses.field(default_factory=list)
    contamination: float = 0.0

    @classmethod
    def load(cls, pon: str | None = None, germline: str | None = None,
             dbsnp: list[str] | None = None,
             cosmic: list[str] | None = None,
             contamination_table: str | None = None
             ) -> "SomaticResources":
        return cls(
            pon=SiteTable(pon) if pon else None,
            germline=SiteTable(germline) if germline else None,
            dbsnp=[SiteTable(p) for p in (dbsnp or [])],
            cosmic=[SiteTable(p) for p in (cosmic or [])],
            contamination=read_contamination_table(contamination_table)
            if contamination_table else 0.0)

    def __bool__(self) -> bool:
        return bool(self.pon or self.germline or self.dbsnp or self.cosmic
                    or self.contamination > 0.0)


def read_contamination_table(path: str) -> float:
    """GATK CalculateContamination output: TSV with a ``contamination``
    column (Mutect2FilterWorker.cpp:66-68 forwards it to the filter)."""
    from ..utils.common import check_input
    with open(check_input(path)) as f:
        header = f.readline().rstrip("\n").split("\t")
        try:
            ci = header.index("contamination")
        except ValueError:
            raise ValueError(
                f"{path}: no 'contamination' column in {header}")
        worst = 0.0
        for line in f:
            if line.strip():
                worst = max(worst, float(line.split("\t")[ci]))
    return worst


def annotate_resources(records: list[VcfRecord], contig: str,
                       start: int, end: int,
                       res: SomaticResources) -> list[VcfRecord]:
    """Annotate emissions against the resource tables (one region query
    per shard): PON flag, POPAF (-log10 population AF from the germline
    resource), rs/COSMIC IDs from dbsnp/cosmic."""
    if not records or not res:
        return records

    def site_map(tables):
        m: dict[tuple[int, str, str], VcfRecord] = {}
        pos_set: set[int] = set()
        for tab in tables:
            for r in tab.records(contig, start, end):
                pos_set.add(r.pos)
                for alt in (r.alts or ["."]):
                    m[(r.pos, r.ref, alt)] = r
        return m, pos_set

    pon_m, pon_pos = site_map([res.pon]) if res.pon else ({}, set())
    germ_m, _ = site_map([res.germline]) if res.germline else ({}, set())
    db_m, _ = site_map(res.dbsnp) if res.dbsnp else ({}, set())
    cos_m, _ = site_map(res.cosmic) if res.cosmic else ({}, set())

    for rec in records:
        key = (rec.pos, rec.ref, rec.alts[0] if rec.alts else ".")
        if res.pon and (key in pon_m or rec.pos in pon_pos):
            rec.info["PON"] = True
        if res.germline:
            g = germ_m.get(key)
            af = 1e-6
            if g is not None:
                try:
                    raw = g.info.get("AF", 1e-6)
                    if isinstance(raw, (list, tuple)):
                        raw = raw[0]
                    af = max(float(raw), 1e-6)
                except (TypeError, ValueError):
                    af = 1e-6
            rec.info["POPAF"] = round(-np.log10(af), 2)
        ids = []
        d = db_m.get(key)
        if d is not None and d.id not in (None, "."):
            ids.append(d.id)
            rec.info["DB"] = True
        c = cos_m.get(key)
        if c is not None and c.id not in (None, "."):
            ids.append(c.id)
        if ids:
            rec.id = ";".join(ids)
    return records


# ---------------------------------------------------------------------------
# FilterMutectCalls analog (ref Mutect2FilterWorker, §2 row 16)
# ---------------------------------------------------------------------------

def _fisher_exact(a: int, b: int, c: int, d: int) -> float:
    """Two-sided Fisher exact p for the 2×2 table [[a, b], [c, d]]."""
    from math import exp, lgamma
    n = a + b + c + d
    if n == 0:
        return 1.0

    def logp(a_, b_, c_, d_):
        return (lgamma(a_ + b_ + 1) + lgamma(c_ + d_ + 1)
                + lgamma(a_ + c_ + 1) + lgamma(b_ + d_ + 1)
                - lgamma(n + 1) - lgamma(a_ + 1) - lgamma(b_ + 1)
                - lgamma(c_ + 1) - lgamma(d_ + 1))

    row1, col1 = a + b, a + c
    lo = max(0, col1 - (c + d))
    hi = min(row1, col1)
    p_obs = logp(a, b, c, d)
    tot = 0.0
    for x in range(lo, hi + 1):
        lp = logp(x, row1 - x, col1 - x, (c + d) - (col1 - x))
        if lp <= p_obs + 1e-7:
            tot += exp(lp)
    return min(1.0, tot)


def filter_mutect_calls(records: list[VcfRecord],
                        min_tlod: float = 6.3,
                        min_alt_reads: int = 2,
                        max_af_normal: float = 0.1,
                        strand_p: float = 0.05,
                        orientation_minor_frac: float = 0.1,
                        orientation_min_alt: int = 4,
                        max_popaf: float = 2.0,
                        contamination: float = 0.0) -> list[VcfRecord]:
    """Annotate FILTER on Mutect2 emissions; returns the same records.

    Filters (GATK FilterMutectCalls analogs): weak_evidence (TLOD),
    low_alt_count, germline (normal AF, or population AF via POPAF from
    the germline resource), strand_bias (Fisher exact on the SB table),
    orientation (F1R2/F2R1 skew — the FFPE/oxoG artifact signature),
    panel_of_normals (PON-annotated sites), contamination (tumor AF at or
    below the contamination fraction)."""
    for r in records:
        filters = []
        tlod = float(r.info.get("TLOD", 0.0))
        if tlod < min_tlod:
            filters.append("weak_evidence")
        if r.info.get("PON"):
            filters.append("panel_of_normals")
        popaf = r.info.get("POPAF")
        if popaf is not None and float(popaf) < max_popaf:
            # common in the population → likely germline, unless the
            # matched normal strongly supports hom-ref at the site
            nlod = float(r.info.get("NLOD", 0.0))
            if nlod < 2.0 * max(1.0, 2.0 - float(popaf)):
                filters.append("germline")
        if contamination > 0.0 and r.samples:
            af_t = float(r.samples[0].get("AF", 1.0))
            if af_t <= contamination:
                filters.append("contamination")
        if r.samples:
            ad = r.samples[0].get("AD", [0, 0])
            ad = [int(x) for x in (ad if isinstance(ad, (list, tuple))
                                   else str(ad).split(","))]
            if len(ad) > 1 and ad[1] < min_alt_reads:
                filters.append("low_alt_count")
            sb = r.samples[0].get("SB")
            if sb is not None:
                if not isinstance(sb, (list, tuple)):
                    sb = [int(x) for x in str(sb).split(",")]
                rf, rr, af, ar = (int(x) for x in sb)
                if (af + ar >= min_alt_reads and min(af, ar) == 0
                        and af + ar >= 3
                        and _fisher_exact(rf, rr, af, ar) < strand_p):
                    filters.append("strand_bias")
        f1r2 = r.info.get("F1R2")
        f2r1 = r.info.get("F2R1")
        if f1r2 is not None and f2r1 is not None:
            f1r2, f2r1 = int(f1r2), int(f2r1)
            total = f1r2 + f2r1
            if (total >= orientation_min_alt
                    and min(f1r2, f2r1) / total <= orientation_minor_frac):
                filters.append("orientation")
        if len(r.samples) > 1 and "germline" not in filters:
            af_n = float(r.samples[1].get("AF", 0.0))
            if af_n > max_af_normal:
                filters.append("germline")
        if len(r.samples) > 1:
            # normal_artifact (GATK FilterMutectCalls): real alt
            # evidence in the matched normal that NLOD's hom-ref vs het
            # contrast misses (2 shared error reads pass a 0.5-AF het
            # test easily).  Alt support in the normal at a rate
            # comparable to the tumor's is an artifact signature.
            ad_n = r.samples[1].get("AD", [0, 0])
            ad_n = [int(x) for x in
                    (ad_n if isinstance(ad_n, (list, tuple))
                     else str(ad_n).split(","))]
            af_t = float(r.samples[0].get("AF", 0.0))
            if len(ad_n) > 1 and ad_n[1] >= 2:
                af_n = ad_n[1] / max(1, ad_n[0] + ad_n[1])
                if af_n >= 0.5 * af_t:
                    filters.append("normal_artifact")
        r.filter = ";".join(filters) if filters else "PASS"
    return records

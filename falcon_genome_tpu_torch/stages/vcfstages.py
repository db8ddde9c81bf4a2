"""VCF utility stages: ``concat``, ``vcf_filter``, ``joint``.

* ``concat``    — fold per-shard VCFs into one bgzip'd output (ref
  VCFConcatWorker → ZIPWorker → TabixWorker chain, worker-concat.cpp).
* ``vcf_filter``— VariantFiltration with a filter expression over
  QUAL/INFO fields (ref VariantsFilterWorker, §2 row 24).
* ``joint``     — joint genotyping across per-sample gVCFs (ref
  CombineGVCFsWorker's GenomicsDB import + GenotypeGVCFs, §2 rows 17-18):
  the vid/callset/loader-JSON + MPI vcf2tiledb machinery becomes an
  in-memory position-keyed merge; per-sample evidence at non-variant
  sites comes from gVCF reference blocks.

Port of ``falcon_genome_tpu/stages/vcfstages.py`` (host code, no kernel).
"""
from __future__ import annotations

import logging
import re
from pathlib import Path

import numpy as np

from ..config import Config
from ..io.vcf import (
    STANDARD_META, VcfHeader, VcfRecord, concat_vcfs, read_vcf, sort_vcf,
    write_vcf)
from ..utils.common import check_input, check_output, get_input_list
from ..utils.errors import InvalidParam

log = logging.getLogger("falcon_genome_tpu")


def run_concat(conf: Config, input_dir: str, output: str,
               sort: bool = True, force: bool = False) -> str:
    output = check_output(output, force)
    parts = get_input_list(input_dir, r".*\.(vcf|gvcf|vcf\.gz)")
    concat_vcfs(parts, output, sort=sort)
    log.info("concat: %d parts → %s", len(parts), output)
    return output


# ---------------------------------------------------------------------------
# vcf_filter
# ---------------------------------------------------------------------------

_CMP = {"<": lambda a, b: a < b, ">": lambda a, b: a > b,
        "<=": lambda a, b: a <= b, ">=": lambda a, b: a >= b,
        "==": lambda a, b: a == b, "!=": lambda a, b: a != b}
_EXPR_RE = re.compile(
    r"\s*([A-Za-z_][A-Za-z0-9_.]*)\s*(<=|>=|==|!=|<|>)\s*([-\d.]+)\s*")


def _eval_filter_expr(expr: str, rec: VcfRecord) -> bool:
    """JEXL-subset evaluation: `FIELD op NUMBER` joined by || or &&.

    FIELD resolves QUAL or an INFO key; missing fields make the clause
    false (GATK's missing-value semantics for filters).
    """
    def clause(c: str) -> bool:
        m = _EXPR_RE.fullmatch(c)
        if not m:
            raise InvalidParam(f"cannot parse filter clause {c!r}")
        field, op, val = m.group(1), m.group(2), float(m.group(3))
        if field == "QUAL":
            have = rec.qual
        else:
            have = rec.info.get(field)
        if have is None:
            return False
        try:
            have = float(have)
        except (TypeError, ValueError):
            return False
        return _CMP[op](have, val)

    for or_part in expr.split("||"):
        if all(clause(c) for c in or_part.split("&&")):
            return True
    return False


def run_vcf_filter(conf: Config, ref: str, input_path: str, output: str,
                   filter_expr: str, filter_name: str = "FILTERED",
                   force: bool = False,
                   extra_opts: list[str] | None = None) -> str:
    from ..utils.extraopts import ExtraOpts
    xo = ExtraOpts(extra_opts)
    # VariantFiltration accepts additional expression/name pairs through
    # --extra-options (VariantsFilterWorker.cpp:43-80 forwards verbatim)
    pairs = [(filter_expr, filter_name)]
    extra_exprs = xo.get_all("--filterExpression", "--filter-expression")
    extra_names = xo.get_all("--filterName", "--filter-name")
    for j, e in enumerate(extra_exprs):
        pairs.append((e.strip('"'),
                      extra_names[j] if j < len(extra_names)
                      else f"FILTER{j + 1}"))
    xo.warn_unused("vcf_filter")
    output = check_output(output, force)
    header, records = read_vcf(check_input(input_path))
    nfail = 0
    for r in records:
        names = [nm for expr, nm in pairs if _eval_filter_expr(expr, r)]
        if names:
            r.filter = ";".join(names)
            nfail += 1
        elif r.filter in (".", ""):
            r.filter = "PASS"
    for expr, nm in pairs:
        header.meta.append(
            f'##FILTER=<ID={nm},Description="{expr}">')
    write_vcf(output, header, records)
    log.info("vcf_filter: %d/%d records filtered → %s",
             nfail, len(records), output)
    return output


# ---------------------------------------------------------------------------
# joint genotyping
# ---------------------------------------------------------------------------

def _sample_evidence(records: list[VcfRecord]):
    """Index one sample's gVCF slice: variants by site + sorted ref blocks
    per contig (binary-searchable)."""
    import bisect
    variants: dict[tuple[str, int], VcfRecord] = {}
    by_contig: dict[str, list[tuple[int, int, int, int]]] = {}
    for r in records:
        if r.is_gvcf_block:
            s0 = r.samples[0] if r.samples else {}
            gq = int(s0.get("GQ", 0) or 0)
            dp = int(s0.get("MIN_DP", s0.get("DP", 0)) or 0)
            by_contig.setdefault(r.contig, []).append(
                (r.pos, int(r.info["END"]), gq, dp))
        else:
            variants[(r.contig, r.pos)] = r
    blocks = {}
    for c, lst in by_contig.items():
        lst.sort()
        blocks[c] = (lst, [b[0] for b in lst])
    return variants, blocks


def _block_at(blocks, contig: str, pos: int) -> tuple[int, int] | None:
    """(GQ, DP) of the hom-ref block covering pos, binary search."""
    import bisect
    ent = blocks.get(contig)
    if ent is None:
        return None
    lst, starts = ent
    i = bisect.bisect_right(starts, pos) - 1
    if i >= 0 and lst[i][0] <= pos <= lst[i][1]:
        return lst[i][2], lst[i][3]
    return None


def _parse_int_list(v) -> list[int] | None:
    """FORMAT list field → ints (handles parsed-string and in-memory forms)."""
    if v is None or v == MISSING_TOK:
        return None
    if isinstance(v, (list, tuple)):
        try:
            return [int(x) for x in v]
        except (TypeError, ValueError):
            return None
    try:
        return [int(x) for x in str(v).split(",")]
    except ValueError:
        return None


MISSING_TOK = "."


def _gt_idx(j: int, k: int) -> int:
    """VCF canonical genotype ordering for diploid (j <= k)."""
    return k * (k + 1) // 2 + j


def _exact_af_qual(site_gls: list[list[float]], theta: float = 1e-3
                   ) -> float | None:
    """Site QUAL from the exact allele-frequency model.

    ``site_gls``: per-sample linear-scale [P(D|0/0), P(D|0/1), P(D|1/1)]
    for one alt (vs everything else).  Runs the Li (2011) exact-AC DP with
    hypergeometric genotype weights, applies the GATK theta prior
    (Pr(AC=k) ∝ θ/k for k>0), and returns -10·log10 posterior(AC=0) — the
    GenotypeGVCFs QUAL semantics, replacing the reference pipeline's
    summed per-sample QUALs (GenotypeGVCFsWorker delegates this to GATK).
    """
    n = len(site_gls)
    if n == 0:
        return None
    # y[k] ∝ P(D_1..j | AC=k); renormalize per step to dodge underflow
    y = np.zeros(2 * n + 1)
    y[0] = 1.0
    for j, (l0, l1, l2) in enumerate(site_gls, start=1):
        ks = np.arange(0, 2 * j + 1, dtype=np.float64)
        prev = y
        nxt = np.zeros_like(y)
        tj = 2.0 * j
        w0 = (tj - ks) * (tj - ks - 1) * l0
        w1 = 2.0 * ks * (tj - ks) * l1
        w2 = ks * (ks - 1) * l2
        nxt[: 2 * j + 1] = w0[: 2 * j + 1] * prev[: 2 * j + 1]
        nxt[1: 2 * j + 1] += w1[1: 2 * j + 1] * prev[: 2 * j]
        nxt[2: 2 * j + 1] += w2[2: 2 * j + 1] * prev[: 2 * j - 1]
        nxt /= tj * (tj - 1.0)
        m = nxt.max()
        y = nxt / m if m > 0 else nxt
    ks = np.arange(1, 2 * n + 1, dtype=np.float64)
    prior = np.empty(2 * n + 1)
    prior[1:] = theta / ks
    prior[0] = max(1.0 - (theta / ks).sum(), 1e-12)
    post = y * prior
    tot = post.sum()
    if tot <= 0:
        return None
    p0 = post[0] / tot
    p0 = min(max(p0, 1e-99), 1.0)
    return -10.0 * np.log10(p0)


def _merge_shard_sites(evidence, sample_names) -> list[VcfRecord]:
    """Position-keyed merge of per-sample evidence within one shard.

    GATK GenotypeGVCFs output semantics (the reference shells this out,
    src/workers/CombineGVCFsWorker.cpp + GenotypeGVCFs):

    * merged REF = longest REF at the site; shorter-REF samples' alleles
      are suffix-extended before matching (indel merge semantics);
    * per-sample AD and PL are REMAPPED into the merged allele list, with
      alleles a sample never saw reading from its ``<NON_REF>`` column
      (the gVCF contract) — AD 0, PL from the NON_REF likelihood;
    * hom-ref-block samples reconstitute GT=0/0 with AD=[DP,0,..] and
      PL=[0,GQ,2GQ] over merged alleles;
    * site QUAL comes from the exact allele-frequency model over all
      samples' PLs (``_exact_af_qual``), not a sum of per-sample QUALs;
    * INFO carries DP/AN/AC/AF/QD.
    """
    sites: dict[tuple[str, int], tuple[str, list[str]]] = {}
    for variants, _ in evidence:
        for (contig, pos), rec in variants.items():
            ref_a, alts = sites.get((contig, pos), (rec.ref, []))
            if len(rec.ref) > len(ref_a):
                ref_a = rec.ref
            sites[(contig, pos)] = (ref_a, alts)
    # second pass: alt alleles in merged (suffix-extended) representation
    for variants, _ in evidence:
        for (contig, pos), rec in variants.items():
            ref_a, alts = sites[(contig, pos)]
            suffix = ref_a[len(rec.ref):]
            for a in rec.alts:
                if a == "<NON_REF>":
                    continue
                a_ext = a + suffix
                if a_ext not in alts:
                    alts.append(a_ext)

    out_records: list[VcfRecord] = []
    for (contig, pos), (ref_a, alts) in sorted(sites.items()):
        if not alts:
            continue
        merged = [ref_a] + alts
        n_gt = _gt_idx(len(alts), len(alts)) + 1
        samples_fmt = []
        total_dp = 0
        an = 0
        ac = np.zeros(len(alts), np.int64)
        dp_var = 0                      # depth over variant-carrying samples
        # per-alt per-sample biallelic GLs for the exact-AF QUAL model
        af_gls: list[list[list[float]]] = [[] for _ in alts]
        for (variants, blocks) in evidence:
            rec = variants.get((contig, pos))
            if rec is not None and rec.samples:
                s = dict(rec.samples[0])
                suffix = ref_a[len(rec.ref):]
                local_raw = [rec.ref] + list(rec.alts)
                # suffix-extended local alleles; NON_REF stays symbolic
                local = [a if a == "<NON_REF>" else a + suffix
                         for a in local_raw]
                nonref_local = (local.index("<NON_REF>")
                                if "<NON_REF>" in local else None)
                # merged index → local index (NON_REF absorbs unseen alts)
                m2l = []
                for a in merged:
                    if a in local:
                        m2l.append(local.index(a))
                    else:
                        m2l.append(nonref_local)

                def remap(tok):
                    if not tok.isdigit():
                        return MISSING_TOK
                    li = int(tok)
                    a = local[li] if li < len(local) else None
                    return str(merged.index(a)) if a in merged \
                        else MISSING_TOK
                gt_raw = str(s.get("GT", "./."))
                s["GT"] = "/".join(
                    remap(t) for t in re.split(r"[/|]", gt_raw))

                ad_local = _parse_int_list(s.get("AD"))
                if ad_local is not None:
                    s["AD"] = [
                        ad_local[m2l[i]]
                        if m2l[i] is not None and m2l[i] < len(ad_local)
                        and local[m2l[i]] != "<NON_REF>" else 0
                        for i in range(len(merged))]
                    # ref column always carries through
                    if ad_local:
                        s["AD"][0] = ad_local[0]
                pl_local = _parse_int_list(s.get("PL"))
                pl_merged = None
                if pl_local is not None:
                    pl_merged = []
                    ok = True
                    for k in range(len(merged)):
                        for j in range(k + 1):
                            lj, lk = m2l[j], m2l[k]
                            if lj is None or lk is None:
                                ok = False
                                break
                            gi = _gt_idx(min(lj, lk), max(lj, lk))
                            if gi >= len(pl_local):
                                ok = False
                                break
                            pl_merged.append(pl_local[gi])
                        if not ok:
                            break
                    if ok and len(pl_merged) == n_gt:
                        mn = min(pl_merged)
                        s["PL"] = [p - mn for p in pl_merged]
                        pl_merged = s["PL"]
                    else:
                        s.pop("PL", None)
                        pl_merged = None
                samples_fmt.append(s)
                dp = int(s.get("DP", 0) or 0)
                total_dp += dp
                called = [int(t) for t in re.split(r"[/|]", s["GT"])
                          if t.isdigit()]
                an += len(called)
                for t in called:
                    if t > 0:
                        ac[t - 1] += 1
                if any(t > 0 for t in called):
                    dp_var += dp
                for ai in range(len(alts)):
                    af_gls[ai].append(_biallelic_gls(pl_merged, ai + 1,
                                                     len(merged)))
            else:
                cov = _block_at(blocks, contig, pos)
                if cov is None:
                    samples_fmt.append({"GT": "./."})
                    for ai in range(len(alts)):
                        af_gls[ai].append([1.0, 1.0, 1.0])
                else:
                    gq, dp = cov
                    # GQ-aware PL reconstitution over the MERGED genotype
                    # space: hom-ref at GQ g caps every ref+alt het at g,
                    # everything else at 2g (GATK GenotypeGVCFs analog)
                    pl = []
                    for k in range(len(merged)):
                        for j in range(k + 1):
                            pl.append(0 if j == k == 0
                                      else gq if j == 0
                                      else max(2 * gq, gq))
                    samples_fmt.append({
                        "GT": "0/0", "GQ": gq, "DP": dp,
                        "AD": [dp] + [0] * len(alts), "PL": pl})
                    total_dp += dp
                    an += 2
                    l1 = 10.0 ** (-gq / 10.0)
                    for ai in range(len(alts)):
                        af_gls[ai].append([1.0, l1, l1 * l1])

        # site QUAL: exact-AF posterior per alt; site-level = max over alts
        # (GATK's joint multiallelic model approximated per-alt)
        quals = [q for q in (_exact_af_qual(af_gls[ai])
                             for ai in range(len(alts))) if q is not None]
        qual = round(max(quals), 2) if quals else None
        info: dict[str, object] = {"DP": total_dp, "AN": an,
                                   "AC": [int(x) for x in ac]}
        if an > 0:
            info["AF"] = [round(float(x) / an, 4) for x in ac]
        if qual is not None and dp_var > 0:
            info["QD"] = round(min(qual / dp_var, 40.0), 2)
        out_records.append(VcfRecord(
            contig=contig, pos=pos, ref=ref_a, alts=alts,
            qual=qual, filter="PASS", info=info,
            fmt=["GT", "AD", "DP", "GQ", "PL"],
            samples=samples_fmt))
    return out_records


def _biallelic_gls(pl_merged: list[int] | None, alt_idx: int,
                   n_alleles: int) -> list[float]:
    """Collapse a merged-space PL to biallelic (ref-vs-alt_idx) linear GLs
    for the exact-AF model; uninformative [1,1,1] without a PL."""
    if pl_merged is None:
        return [1.0, 1.0, 1.0]
    l0 = 10.0 ** (-pl_merged[_gt_idx(0, 0)] / 10.0)
    l1 = 10.0 ** (-pl_merged[_gt_idx(0, alt_idx)] / 10.0)
    l2 = 10.0 ** (-pl_merged[_gt_idx(alt_idx, alt_idx)] / 10.0)
    return [l0, l1, l2]


def run_joint(conf: Config, ref: str, input_path: str, output: str,
              force: bool = False,
              extra_opts: list[str] | None = None) -> str:
    """Joint genotyping: merge per-sample gVCFs into a multi-sample VCF.

    Scatter/gather like the reference's joint driver (GenomicsDB import +
    per-contig GenotypeGVCFs, worker-joint.cpp): the genome is split into
    ``gatk.joint.ncontigs`` shards, each shard streams only its region
    from every sample's gVCF via the ``.tbi`` index; unindexed inputs are
    bgzip+tabix'd once into the work dir (the reference's ZIP/Tabix
    preconditioning) so per-shard memory stays O(shard), never O(file)."""
    from ..io.intervals import split_equal_bp
    from ..io.tabix import query_vcf_region
    from ..io.vcf import ensure_indexed_vcf
    from ..pipeline.runner import PipelineRunner, stage
    from ..utils.common import get_contig_fname
    from ..utils.extraopts import ExtraOpts
    from .common import load_fasta

    xo = ExtraOpts(extra_opts)
    # GenotypeGVCFs emission threshold (GATK -stand_call_conf)
    call_conf = xo.get_float(
        "-stand_call_conf",
        "--standard_min_confidence_threshold_for_calling")
    xo.warn_unused("joint")
    output = check_output(output, force)
    if Path(input_path).is_dir():
        paths = get_input_list(input_path, r".*\.(g\.vcf|gvcf)(\.gz)?")
    else:
        paths = [check_input(input_path)]

    fa = load_fasta(ref)
    shards = split_equal_bp(fa.dict, conf.get("gatk.joint.ncontigs"))

    part_dir = Path(output).parent / (Path(output).name + ".parts")
    part_dir.mkdir(parents=True, exist_ok=True)

    sample_names: list[str] = []
    contigs = None
    import gzip
    paths = [ensure_indexed_vcf(p, part_dir / "indexed") for p in paths]
    for p in paths:
        with gzip.open(p, "rt") as f:   # streams: header lines only
            lines = []
            for line in f:
                if not line.startswith("#"):
                    break
                lines.append(line)
        header = VcfHeader.from_lines(lines)
        sample_names.append(header.samples[0] if header.samples
                            else Path(p).stem)
        contigs = contigs or header.contigs

    part_paths = [get_contig_fname(part_dir, i, "vcf")
                  for i in range(len(shards))]

    def one(shard, idx):
        evidence = []
        for p in paths:
            recs: list[VcfRecord] = []
            for iv in shard:
                recs.extend(query_vcf_region(
                    p, iv.contig, iv.start, iv.end))
            evidence.append(_sample_evidence(recs))
        # a variant belongs to the shard that contains its POS (avoids
        # double emission when an overlapping record enters two shards)
        for variants, _ in evidence:
            for key in [k for k in variants
                        if not any(iv.contig == k[0]
                                   and iv.start <= k[1] <= iv.end
                                   for iv in shard)]:
                del variants[key]
        recs = _merge_shard_sites(evidence, sample_names)
        if call_conf is not None:
            recs = [r for r in recs
                    if r.qual is None or r.qual >= call_conf]
        path = part_paths[idx]
        hdr = VcfHeader(contigs=contigs or [], samples=sample_names,
                        meta=list(STANDARD_META))
        write_vcf(path, hdr, recs)
        return path

    runner = PipelineRunner.from_conf("Joint Genotyping", conf,
                                      force=force)
    tasks = [(lambda s=s, i=i: one(s, i)) for i, s in enumerate(shards)]
    (parts,) = runner.run([stage(
        "GenotypeGVCFs", tasks, outputs=part_paths,
        nprocs=conf.get("gatk.joint.nprocs", "gatk.nprocs"))]).values()

    concat_vcfs(list(parts), output, sort=False)
    n = sum(1 for _ in parts)
    log.info("joint: %d samples, %d shards → %s",
             len(sample_names), n, output)
    return output

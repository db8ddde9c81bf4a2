"""Base-quality score recalibration (BQSR): covariate histogram + remap.

Port of ``falcon_genome_tpu/bqsr.py``, its single-device host path: the
hot loop is a pure reduction — a segmented histogram of (observations,
errors) over covariate bins — counted on the host (the fgio extension's
one-pass histogram, else ``np.bincount``), and the gather step of the
reference (BQSRGatherWorker merging per-contig tables,
BQSRWorker.cpp:111-150) is exactly ``+`` on the histogram arrays.

Covariates (GATK's standard set):
  * read group
  * reported base quality
  * machine cycle (position in read, negative strand reversed)
  * dinucleotide context (previous base + current base)

The recalibrated quality is the additive hierarchical model
(global shift → per-qual delta → cycle and context deltas), each level
computed from Bayesian-smoothed empirical qualities.
"""
from __future__ import annotations

import dataclasses

import numpy as np


MAX_QUAL = 94
MAX_CYCLE = 512           # cycle bins: [-256, 256) offset by 256
N_CONTEXT = 16            # dinucleotide (prev, cur) 4x4
MIN_USABLE_QUAL = 6       # GATK: bases below this are not recalibrated


@dataclasses.dataclass
class RecalTable:
    """Per-read-group covariate histograms (observations & errors)."""
    read_groups: list[str]
    qual_obs: np.ndarray      # (nrg, MAX_QUAL)
    qual_err: np.ndarray
    cycle_obs: np.ndarray     # (nrg, MAX_QUAL, MAX_CYCLE)
    cycle_err: np.ndarray
    ctx_obs: np.ndarray       # (nrg, MAX_QUAL, N_CONTEXT)
    ctx_err: np.ndarray

    @classmethod
    def zeros(cls, read_groups: list[str]) -> "RecalTable":
        n = len(read_groups)
        return cls(
            read_groups,
            np.zeros((n, MAX_QUAL)), np.zeros((n, MAX_QUAL)),
            np.zeros((n, MAX_QUAL, MAX_CYCLE)),
            np.zeros((n, MAX_QUAL, MAX_CYCLE)),
            np.zeros((n, MAX_QUAL, N_CONTEXT)),
            np.zeros((n, MAX_QUAL, N_CONTEXT)))

    def __add__(self, other: "RecalTable") -> "RecalTable":
        """Table gather = addition (ref BQSRGatherWorker)."""
        assert self.read_groups == other.read_groups
        return RecalTable(
            self.read_groups,
            *(getattr(self, f) + getattr(other, f)
              for f in ("qual_obs", "qual_err", "cycle_obs", "cycle_err",
                        "ctx_obs", "ctx_err")))

    def save(self, path: str) -> str:
        np.savez(path, read_groups=np.array(self.read_groups),
                 **{f: getattr(self, f) for f in (
                     "qual_obs", "qual_err", "cycle_obs", "cycle_err",
                     "ctx_obs", "ctx_err")})
        return path

    @classmethod
    def load(cls, path: str) -> "RecalTable":
        """Load a table: ``.npz`` (fast private format) or a GATK-format
        recalibration report (the reference's interchange format —
        BQSRWorker.cpp:111-150 gathers GATK reports)."""
        import os
        if not path.endswith(".npz") and os.path.exists(path):
            with open(path, "rb") as f:
                if f.read(12).startswith(b"#:GATKReport"):
                    return read_gatk_report(path)
        z = np.load(path if path.endswith(".npz") else path + ".npz",
                    allow_pickle=False)
        return cls([str(s) for s in z["read_groups"]],
                   z["qual_obs"], z["qual_err"], z["cycle_obs"],
                   z["cycle_err"], z["ctx_obs"], z["ctx_err"])


# ---------------------------------------------------------------------------
# GATK-format recalibration report (the reference's table interchange
# format: BaseRecalibrator emits it, GatherBqsrReports merges it, PrintReads
# consumes it — BQSRWorker.cpp:111-150)
# ---------------------------------------------------------------------------

_BASES = "ACGT"


def _ctx_str(i: int) -> str:
    return _BASES[i // 4] + _BASES[i % 4]


def _emp_q(err: np.ndarray | float, obs: np.ndarray | float) -> np.ndarray:
    """GATK's smoothed empirical quality: phred((err+1)/(obs+2))."""
    return -10.0 * np.log10((np.asarray(err, np.float64) + 1.0)
                            / (np.asarray(obs, np.float64) + 2.0))


def write_gatk_report(table: RecalTable, path: str) -> str:
    """Write the table as a GATKReport v1.1 recalibration report.

    Tables: RecalTable0 (per read group), RecalTable1 (per RG × reported
    quality), RecalTable2 (per RG × quality × {Context, Cycle} covariate).
    Event type is ``M`` (base mismatches — the model this engine fits).
    """
    reported = np.arange(MAX_QUAL, dtype=np.float64)
    lines: list[str] = []

    rows0 = []
    for g, rg in enumerate(table.read_groups):
        obs = table.qual_obs[g].sum()
        err = table.qual_err[g].sum()
        est = ((table.qual_obs[g] * reported).sum() / obs) if obs else 0.0
        rows0.append((rg, "M", float(_emp_q(err, obs)), est,
                      int(obs), err))
    lines.append(f"#:GATKTable:6:{len(rows0)}:%s:%s:%.4f:%.4f:%d:%.2f:;")
    lines.append("#:GATKTable:RecalTable0:")
    lines.append("ReadGroup\tEventType\tEmpiricalQuality\t"
                 "EstimatedQReported\tObservations\tErrors")
    for rg, ev, emp, est, obs, err in rows0:
        lines.append(f"{rg}\t{ev}\t{emp:.4f}\t{est:.4f}\t{obs}\t{err:.2f}")
    lines.append("")

    rows1 = []
    for g, rg in enumerate(table.read_groups):
        for q in range(MAX_QUAL):
            obs = table.qual_obs[g, q]
            if obs > 0:
                rows1.append((rg, q, "M",
                              float(_emp_q(table.qual_err[g, q], obs)),
                              int(obs), table.qual_err[g, q]))
    lines.append(f"#:GATKTable:6:{len(rows1)}:%s:%d:%s:%.4f:%d:%.2f:;")
    lines.append("#:GATKTable:RecalTable1:")
    lines.append("ReadGroup\tQualityScore\tEventType\tEmpiricalQuality\t"
                 "Observations\tErrors")
    for rg, q, ev, emp, obs, err in rows1:
        lines.append(f"{rg}\t{q}\t{ev}\t{emp:.4f}\t{obs}\t{err:.2f}")
    lines.append("")

    rows2 = []
    for g, rg in enumerate(table.read_groups):
        gq, gctx = np.nonzero(table.ctx_obs[g])
        for q, c in zip(gq.tolist(), gctx.tolist()):
            rows2.append((rg, q, _ctx_str(c), "Context", "M",
                          float(_emp_q(table.ctx_err[g, q, c],
                                       table.ctx_obs[g, q, c])),
                          int(table.ctx_obs[g, q, c]),
                          table.ctx_err[g, q, c]))
        gq, gcyc = np.nonzero(table.cycle_obs[g])
        for q, cy in zip(gq.tolist(), gcyc.tolist()):
            rows2.append((rg, q, str(cy), "Cycle", "M",
                          float(_emp_q(table.cycle_err[g, q, cy],
                                       table.cycle_obs[g, q, cy])),
                          int(table.cycle_obs[g, q, cy]),
                          table.cycle_err[g, q, cy]))
    lines.append(
        f"#:GATKTable:8:{len(rows2)}:%s:%d:%s:%s:%s:%.4f:%d:%.2f:;")
    lines.append("#:GATKTable:RecalTable2:")
    lines.append("ReadGroup\tQualityScore\tCovariateValue\tCovariateName\t"
                 "EventType\tEmpiricalQuality\tObservations\tErrors")
    for rg, q, cv, cn, ev, emp, obs, err in rows2:
        lines.append(
            f"{rg}\t{q}\t{cv}\t{cn}\t{ev}\t{emp:.4f}\t{obs}\t{err:.2f}")
    lines.append("")

    with open(path, "w") as f:
        f.write(f"#:GATKReport.v1.1:{3}\n")
        f.write("\n".join(lines))
    return path


def read_gatk_report(path: str) -> RecalTable:
    """Parse a GATK-format recalibration report back into a RecalTable.

    Context strings map onto the dinucleotide bins; cycle covariate
    values are this engine's cycle bins (non-negative ints); rows with
    unrecognized covariates are skipped."""
    rgs: list[str] = []
    rows1: list[tuple] = []
    rows2: list[tuple] = []
    section = None
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("#:GATKTable:RecalTable"):
                section = line.split(":")[2].rstrip(":")
                continue
            if line.startswith("#:") or not line.strip():
                continue
            if line.startswith("ReadGroup\t"):
                continue
            parts = line.split("\t")
            if section == "RecalTable0":
                if parts[0] not in rgs:
                    rgs.append(parts[0])
            elif section == "RecalTable1":
                rows1.append((parts[0], int(parts[1]), float(parts[4]),
                              float(parts[5])))
            elif section == "RecalTable2":
                rows2.append((parts[0], int(parts[1]), parts[2], parts[3],
                              float(parts[6]), float(parts[7])))
    table = RecalTable.zeros(rgs or ["default"])
    gi = {rg: i for i, rg in enumerate(table.read_groups)}
    for rg, q, obs, err in rows1:
        g = gi.get(rg, 0)
        table.qual_obs[g, q] += obs
        table.qual_err[g, q] += err
    for rg, q, cv, cn, obs, err in rows2:
        g = gi.get(rg, 0)
        if cn == "Context" and len(cv) == 2 and all(b in _BASES
                                                    for b in cv):
            c = _BASES.index(cv[0]) * 4 + _BASES.index(cv[1])
            table.ctx_obs[g, q, c] += obs
            table.ctx_err[g, q, c] += err
        elif cn == "Cycle":
            try:
                cy = int(cv)
            except ValueError:
                continue
            if 0 <= cy < MAX_CYCLE:
                table.cycle_obs[g, q, cy] += obs
                table.cycle_err[g, q, cy] += err
    return table


def _rg_array(cols, idx: np.ndarray,
              rg_index: dict[str, int] | None) -> np.ndarray:
    """Per-record read-group index for the records in ``idx``."""
    from falcon_genome_tpu.io.columns import tag_string_values
    if not rg_index or len(rg_index) <= 1:
        return np.zeros(len(idx), np.int32)
    vals = tag_string_values(cols, b"RG", idx=idx)
    return np.asarray([rg_index.get(v or "", 0) for v in vals], np.int32)


def _ref_layout(ref_codes_by_tid: dict[int, np.ndarray]):
    """(refcat, tid_ok, tid_len, tid_off, max_tid) concat layout."""
    max_tid = max(ref_codes_by_tid)
    tid_ok = np.zeros(max_tid + 2, bool)
    tid_len = np.zeros(max_tid + 2, np.int64)
    tid_off = np.zeros(max_tid + 2, np.int64)
    parts = []
    off = 0
    for t in sorted(ref_codes_by_tid):
        tid_ok[t] = True
        tid_len[t] = len(ref_codes_by_tid[t])
        tid_off[t] = off
        off += tid_len[t]
        parts.append(ref_codes_by_tid[t])
    refcat = (np.concatenate(parts) if parts else np.zeros(0, np.uint8))
    return refcat, tid_ok, tid_len, tid_off, max_tid


def baserecal_shard_table(cols, ref_codes_by_tid: dict[int, np.ndarray],
                          known_sites=None,
                          rg_index: dict[str, int] | None = None,
                          read_groups: list[str] | None = None
                          ) -> "RecalTable":
    """Per-shard BaseRecalibrator table: native one-pass histograms
    when the extension is built (~40× the numpy expansion at WGS shard
    scale), else the chunked python extraction.  Both paths produce
    identical tables (test-gated)."""
    from falcon_genome_tpu.io import native_ext

    rgs = read_groups or ["default"]
    if native_ext.available() and ref_codes_by_tid and len(cols):
        from falcon_genome_tpu.io.columns import (F_FLAG, F_LSEQ, F_QSTAR, F_TID,
                                 qual_phred_blob, seq_codes_blob)
        refcat, tid_ok, tid_len, tid_off, max_tid = _ref_layout(
            ref_codes_by_tid)
        f = cols.fixed
        tid = f[:, F_TID]
        sel = np.flatnonzero(
            ((f[:, F_FLAG] & 0xD04) == 0)
            & (f[:, F_LSEQ] > 0) & (f[:, F_QSTAR] == 0)
            & (tid >= 0) & (tid <= max_tid)
            & tid_ok[np.clip(tid, 0, max_tid)])
        if len(sel):
            known = None
            if known_sites:
                known = np.zeros(len(refcat), np.uint8)
                items = (known_sites.items()
                         if isinstance(known_sites, dict) else None)
                if items is not None:
                    for t, ps in items:
                        if 0 <= t <= max_tid and tid_ok[t]:
                            ps = np.asarray(ps, np.int64)
                            known[tid_off[t] + ps[ps < tid_len[t]]] = 1
                else:
                    for t, p in known_sites:
                        if (0 <= t <= max_tid and tid_ok[t]
                                and p < tid_len[t]):
                            known[tid_off[t] + p] = 1
            hist = native_ext.bqsr_hist(
                cols.fixed, sel, _rg_array(cols, sel, rg_index),
                cols.cig_off, cols.cigar_ops, cols.cigar_lens,
                cols.seq_off, seq_codes_blob(cols),
                qual_phred_blob(cols), refcat, tid_off, tid_len, known,
                len(rgs))
            if hist is not None:
                qo, qe, co, ce, xo, xe = hist
                return RecalTable(rgs, qo, qe, co, ce, xo, xe)
    # python fallback: chunked extraction (the covariate arrays are
    # ~15 per-base int64 temps — chunks cap the working set)
    CH = 65536
    total = None
    n = len(cols)
    for a in range(0, max(n, 1), CH):
        sub = (cols if n <= CH
               else cols.take(np.arange(a, min(a + CH, n))))
        cov = extract_covariates_columns(sub, ref_codes_by_tid,
                                         known_sites, rg_index)
        part = accumulate_table(cov, rgs)
        total = part if total is None else total + part
        if n <= CH:
            break
    return total


def extract_covariates_columns(cols,
                               ref_codes_by_tid: dict[int, np.ndarray],
                               known_sites: set[tuple[int, int]]
                               | dict[int, np.ndarray] | None = None,
                               rg_index: dict[str, int] | None = None
                               ) -> dict[str, np.ndarray]:
    """Covariate arrays (rg, qual, cycle, context, is_error) of the
    eligible aligned bases of RecordColumns.

    Skips unmapped/dup/secondary/supplementary reads, soft-clipped and N
    bases, quals < MIN_USABLE_QUAL, and known-site positions."""
    from falcon_genome_tpu.io.columns import (
        F_FLAG, F_LSEQ, F_QSTAR, F_TID, expand_match_bases, qual_phred_blob,
        seq_codes_blob)

    f = cols.fixed
    if not ref_codes_by_tid:
        return {k: np.zeros(0, np.int32) for k in
                ("rg", "qual", "cycle", "context")} | {
                    "is_error": np.zeros(0, np.float32)}
    max_tid = max(ref_codes_by_tid)
    tid_ok = np.zeros(max_tid + 2, bool)
    tid_len = np.zeros(max_tid + 2, np.int64)
    tid_off = np.zeros(max_tid + 2, np.int64)
    refcat_parts = []
    off = 0
    for t in sorted(ref_codes_by_tid):
        tid_ok[t] = True
        tid_len[t] = len(ref_codes_by_tid[t])
        tid_off[t] = off
        off += tid_len[t]
        refcat_parts.append(ref_codes_by_tid[t])
    refcat = (np.concatenate(refcat_parts) if refcat_parts
              else np.zeros(0, np.uint8))

    tid = f[:, F_TID]
    sel = np.flatnonzero(
        ((f[:, F_FLAG] & 0xD04) == 0)       # unmapped|dup|secondary|supp
        & (f[:, F_LSEQ] > 0) & (f[:, F_QSTAR] == 0)
        & (tid >= 0) & (tid <= max_tid) & tid_ok[np.clip(tid, 0, max_tid)])
    if len(sel) == 0:
        return {k: np.zeros(0, np.int32) for k in
                ("rg", "qual", "cycle", "context")} | {
                    "is_error": np.zeros(0, np.float32)}

    rec, qpos, rpos = expand_match_bases(cols, sel)
    codes = seq_codes_blob(cols)
    phred = qual_phred_blob(cols)
    soff = cols.seq_off[sel].astype(np.int64)
    bidx = soff[rec] + qpos
    base = codes[bidx].astype(np.int32)
    q = phred[bidx].astype(np.int32)
    L = f[sel, F_LSEQ].astype(np.int64)[rec]
    rev = (f[sel, F_FLAG][rec] & 0x10) != 0
    cyc = np.minimum(np.where(rev, L - 1 - qpos, qpos),
                     MAX_CYCLE - 1).astype(np.int32)
    prev_i = np.where(rev, qpos + 1, qpos - 1)
    valid_prev = (prev_i >= 0) & (prev_i < L)
    prev = codes[soff[rec] + np.clip(prev_i, 0, np.maximum(L - 1, 0))]
    ctx = np.where(valid_prev & (prev != 4),
                   prev.astype(np.int32) * 4 + base, 0)

    rtid = f[sel, F_TID].astype(np.int64)[rec]
    in_ref = rpos < tid_len[rtid]
    gpos = tid_off[rtid] + np.minimum(rpos, tid_len[rtid] - 1)
    ref_base = refcat[np.clip(gpos, 0, max(len(refcat) - 1, 0))]

    known_mask = np.zeros(len(rec), bool)
    if known_sites:
        if isinstance(known_sites, dict):
            # streamed form: {tid: sorted per-base positions} numpy
            # arrays (KnownSites.for_shard) — no Python tuple set
            parts = []
            for t, ps in known_sites.items():
                if 0 <= t <= max_tid and tid_ok[t]:
                    ps = np.asarray(ps, np.int64)
                    parts.append(tid_off[t] + ps[ps < tid_len[t]])
            kg = (np.sort(np.concatenate(parts)) if parts
                  else np.zeros(0, np.int64))
        else:
            kg = np.sort(np.asarray(
                [tid_off[t] + p for t, p in known_sites
                 if 0 <= t <= max_tid and tid_ok[t] and p < tid_len[t]],
                np.int64))
        if len(kg):
            j = np.searchsorted(kg, gpos)
            known_mask = (j < len(kg)) & (kg[np.minimum(j, len(kg) - 1)]
                                          == gpos) & in_ref

    ok = ((base != 4) & (q >= MIN_USABLE_QUAL) & in_ref & ~known_mask)
    rg_sel = _rg_array(cols, sel, rg_index)
    return {
        "rg": rg_sel[rec[ok]],
        "qual": q[ok],
        "cycle": cyc[ok],
        "context": ctx[ok].astype(np.int32),
        "is_error": (base[ok] != ref_base[ok]).astype(np.float32),
    }


def apply_bqsr_columns(cols, model: "RecalModel",
                       rg_index: dict[str, int] | None = None,
                       preserve_below: int | None = None):
    """Vectorized ApplyBQSR on RecordColumns: one recalibrate() over every
    base of every record, written back into a fresh qual blob."""
    from falcon_genome_tpu.io.columns import (
        F_FLAG, F_LSEQ, F_QSTAR, qual_phred_blob, seq_codes_blob)

    f = cols.fixed
    sel = np.flatnonzero((f[:, F_LSEQ] > 0) & (f[:, F_QSTAR] == 0))
    if len(sel) == 0:
        return cols

    from falcon_genome_tpu.io import native_ext
    if native_ext.available():
        # lookup-table fast path: one gather per base in C (the numpy
        # expansion below — the correctness reference — materialises
        # per-base temps and cost ~40 s per WGS shard)
        pb = (MIN_USABLE_QUAL if preserve_below is None
              else preserve_below)
        delta = 33 if cols.qual_mode == "ascii" else 0
        qual_out = cols.qual.copy()
        ok = native_ext.bqsr_apply(
            cols.fixed, sel, _rg_array(cols, sel, rg_index),
            cols.seq_off, seq_codes_blob(cols), cols.qual,
            model.full_table(), pb, delta, delta, qual_out)
        if ok:
            cols.qual = qual_out
            return cols

    lseq = f[sel, F_LSEQ].astype(np.int64)
    nb = int(lseq.sum())
    bbase = np.cumsum(lseq) - lseq
    rec = np.repeat(np.arange(len(sel)), lseq)
    idx = np.arange(nb) - np.repeat(bbase, lseq)
    soff = cols.seq_off[sel].astype(np.int64)
    flat = soff[rec] + idx

    codes = seq_codes_blob(cols)
    phred = qual_phred_blob(cols)
    q = phred[flat].astype(np.int32)
    L = lseq[rec]
    rev = (f[sel, F_FLAG][rec] & 0x10) != 0
    cyc = np.minimum(np.where(rev, L - 1 - idx, idx),
                     MAX_CYCLE - 1).astype(np.int32)
    prev_i = np.where(rev, idx + 1, idx - 1)
    valid_prev = (prev_i >= 0) & (prev_i < L)
    prev = codes[soff[rec] + np.clip(prev_i, 0, np.maximum(L - 1, 0))]
    cur = np.minimum(codes[flat], 3).astype(np.int32)
    ctx = np.where(valid_prev & (prev != 4),
                   prev.astype(np.int32) * 4 + cur, 0)
    rg_sel = _rg_array(cols, sel, rg_index)
    newq = model.recalibrate(rg_sel[rec], np.clip(q, 0, MAX_QUAL - 1),
                             cyc, ctx, preserve_below=preserve_below)
    qual = cols.qual.copy()
    qual[flat] = (newq + (33 if cols.qual_mode == "ascii" else 0)
                  ).astype(np.uint8)
    cols.qual = qual
    return cols


def accumulate_table(cov: dict[str, np.ndarray],
                     read_groups: list[str]) -> RecalTable:
    """Histogram the covariate arrays into a RecalTable (host bincount:
    integer counts and f64 error sums, exact)."""
    nrg = max(1, len(read_groups))
    n = len(cov["rg"])
    if n == 0:
        return RecalTable.zeros(read_groups or ["default"])
    rg = cov["rg"].astype(np.int64)
    # clamp qual into bin range: unusual BAMs can carry quals >= MAX_QUAL
    # (they pass the MIN_USABLE_QUAL lower bound); the removed device
    # scatter-add dropped out-of-range indices silently, but bincount
    # would grow past `size` and break the reshape — clamp reproduces
    # the deterministic "top bin" semantics instead
    qual = np.minimum(cov["qual"].astype(np.int64), MAX_QUAL - 1)
    err = cov["is_error"].astype(np.float64)
    qf = rg * MAX_QUAL + qual

    def hist(key, size):
        obs = np.bincount(key, minlength=size).astype(np.float64)
        e = np.bincount(key, weights=err, minlength=size)
        return obs, e

    qual_obs, qual_err = hist(qf, nrg * MAX_QUAL)
    cyc_obs, cyc_err = hist(qf * MAX_CYCLE + cov["cycle"],
                            nrg * MAX_QUAL * MAX_CYCLE)
    ctx_obs, ctx_err = hist(qf * N_CONTEXT + cov["context"],
                            nrg * MAX_QUAL * N_CONTEXT)
    return RecalTable(
        read_groups or ["default"],
        qual_obs.reshape(nrg, MAX_QUAL), qual_err.reshape(nrg, MAX_QUAL),
        cyc_obs.reshape(nrg, MAX_QUAL, MAX_CYCLE),
        cyc_err.reshape(nrg, MAX_QUAL, MAX_CYCLE),
        ctx_obs.reshape(nrg, MAX_QUAL, N_CONTEXT),
        ctx_err.reshape(nrg, MAX_QUAL, N_CONTEXT))


# ---------------------------------------------------------------------------
# recalibration model
# ---------------------------------------------------------------------------

def _phred(err_rate: np.ndarray) -> np.ndarray:
    return -10.0 * np.log10(np.clip(err_rate, 1e-10, 1.0))


PRIOR_WEIGHT = 2.0  # pseudo-observations anchoring each bin to its parent


def _empirical(obs: np.ndarray, err: np.ndarray,
               parent_q: np.ndarray | float) -> np.ndarray:
    """Empirical quality shrunk toward the parent level's prediction.

    Pseudo-counts are *parent-consistent* (PRIOR_WEIGHT observations at
    the parent's error rate) rather than flat +1/+2 — a flat prior caps a
    zero-error bin's quality at phred(1/obs) and drags clean small bins
    below their parent (a delta that should be ~0 becomes negative).
    """
    p_parent = np.power(10.0, -np.asarray(parent_q, np.float64) / 10.0)
    return _phred((err + PRIOR_WEIGHT * p_parent)
                  / (obs + PRIOR_WEIGHT))


@dataclasses.dataclass
class RecalModel:
    """Additive hierarchical recalibration, queryable per base."""
    table: RecalTable
    global_delta: np.ndarray       # (nrg,)
    qual_delta: np.ndarray         # (nrg, MAX_QUAL)
    cycle_delta: np.ndarray        # (nrg, MAX_QUAL, MAX_CYCLE)
    ctx_delta: np.ndarray          # (nrg, MAX_QUAL, N_CONTEXT)

    @classmethod
    def fit(cls, table: RecalTable) -> "RecalModel":
        reported = np.arange(MAX_QUAL, dtype=np.float64)

        # global: expected errors under reported quals vs observed
        exp_err = (table.qual_obs *
                   10.0 ** (-reported[None, :] / 10.0)).sum(axis=1)
        tot_obs = table.qual_obs.sum(axis=1)
        tot_err = table.qual_err.sum(axis=1)
        rep_global = _phred((exp_err + 1.0) / (tot_obs + 2.0))
        emp_global = _empirical(tot_obs, tot_err, rep_global)
        global_delta = emp_global - rep_global

        parent_qual = reported[None, :] + global_delta[:, None]
        emp_qual = _empirical(table.qual_obs, table.qual_err, parent_qual)
        qual_delta = np.where(table.qual_obs > 0, emp_qual - parent_qual,
                              0.0)

        # base prediction after the first two levels: (nrg, MAX_QUAL)
        base_q = parent_qual + qual_delta
        emp_cycle = _empirical(table.cycle_obs, table.cycle_err,
                               base_q[:, :, None])
        cycle_delta = np.where(table.cycle_obs > 0,
                               emp_cycle - base_q[:, :, None], 0.0)
        emp_ctx = _empirical(table.ctx_obs, table.ctx_err,
                             base_q[:, :, None])
        ctx_delta = np.where(table.ctx_obs > 0,
                             emp_ctx - base_q[:, :, None], 0.0)
        return cls(table, global_delta, qual_delta, cycle_delta, ctx_delta)

    def recalibrate(self, rg: np.ndarray, qual: np.ndarray,
                    cycle: np.ndarray, context: np.ndarray,
                    preserve_below: int | None = None) -> np.ndarray:
        """Vectorized remap: arrays of covariates → new quals (int).

        ``preserve_below`` is GATK's ``--preserve_qscores_less_than``
        (default = MIN_USABLE_QUAL, the GATK default of 6)."""
        if preserve_below is None:
            preserve_below = MIN_USABLE_QUAL
        q = (qual.astype(np.float64)
             + self.global_delta[rg]
             + self.qual_delta[rg, qual]
             + self.cycle_delta[rg, qual, cycle]
             + self.ctx_delta[rg, qual, context])
        out = np.clip(np.rint(q), 2, MAX_QUAL - 1).astype(np.int32)
        return np.where(qual < preserve_below, qual, out)

    def full_table(self) -> np.ndarray:
        """(nrg, 94, 512, 16) uint8 recalibrated-qual lookup: the
        additive delta model materialised once (~0.77 MB/rg) so the
        per-base apply is a single gather (native fg_bqsr_apply)."""
        cached = getattr(self, "_full_table", None)
        if cached is not None:
            return cached
        nrg = self.global_delta.shape[0]
        q = np.arange(MAX_QUAL, dtype=np.float64)
        tab = (q[None, :, None, None]
               + self.global_delta[:, None, None, None]
               + self.qual_delta[:, :, None, None]
               + self.cycle_delta[:, :, :, None]
               + self.ctx_delta[:, :, None, :])
        tab = np.clip(np.rint(tab), 2, MAX_QUAL - 1).astype(np.uint8)
        assert tab.shape == (nrg, MAX_QUAL, MAX_CYCLE, N_CONTEXT)
        self._full_table = tab
        return tab

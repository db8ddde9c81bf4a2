"""Likelihood calls as the port's HaplotypeCaller and Mutect2 send them.

The traffic file gives the shapes of an active region, the configuration
the sample (depths, error rate, variant rates, allele fractions).  Each
region is a reference span of ``hap_len_min``..``hap_len_max`` bases, a
set of ``haps_min``..``haps_max`` candidate haplotypes (the reference
span, the variant that made the region active, and assembly's other
candidates: a few SNPs or a short indel each) and the reads overlapping
it, clipped to it, drawn from the sample's haplotypes with the
configuration's quality profile and substitution errors.  The variant is
a germline het or, at the configuration's share of somatic to germline
rates, a somatic one; each read group carries it at its ``germline_af``
or ``somatic_af``.  The pool's ``pool_regions`` regions have the same
sizes on every seed (drawn from the traffic's ``shape_seed``); the run's
seed orders them and draws their bases, edits, read sources and errors,
so that the work does not move with the seed.  Calls are the regions'
cross products (every read x every haplotype) grouped greedily up to
``max_pairs_per_call`` pairs and cut at that many, as
``models/haplotypecaller.py`` ``_likelihoods_multi`` groups them.

The program's entry is ``ops.pairhmm.pairhmm_logp_pairs`` (host tables,
gather on the device, kernel K4, results back on the host).  The check
recomputes every pair of a sample of the window's calls with the plain
recurrence of ``reference/pairhmm.py`` in float64 and compares the
widest gap in log10 likelihood.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from reference import pairhmm as ref_pairhmm
import roofline

UNIT = "pairs"


@dataclasses.dataclass
class Call:
    reads: np.ndarray       # (NR, R') codes, N-padded
    quals: np.ndarray       # (NR, R') phreds
    rlens: np.ndarray       # (NR,)
    haps: np.ndarray        # (NH, H') codes
    hlens: np.ndarray       # (NH,)
    pair_read: np.ndarray   # (B,)
    pair_hap: np.ndarray    # (B,)

    @property
    def pairs(self) -> int:
        return len(self.pair_read)


@dataclasses.dataclass
class Shape:
    """The sizes of one active region, the same for every seed: its span,
    each candidate haplotype's edit (kind, size), each read group's read
    starts (relative to the span) and whether its variant is somatic."""
    span: int
    edits: list
    starts: list
    somatic: bool


def _shape(rng, config: dict, traffic: dict) -> Shape:
    span = int(rng.integers(traffic["hap_len_min"],
                            traffic["hap_len_max"] + 1))
    n_haps = int(rng.integers(traffic["haps_min"], traffic["haps_max"] + 1))
    edits = []
    for _ in range(n_haps - 1):
        if rng.random() < traffic["indel_share"]:
            kind = "ins" if rng.random() < 0.5 else "del"
            edits.append((kind, int(rng.integers(1, traffic["indel_max"]
                                                 + 1))))
        else:
            edits.append(("snp", int(rng.integers(1, 4))))
    L = config["read_len"]
    starts = []
    for group in config["read_groups"]:
        n = int(rng.poisson(group["depth"] * (span + L) / L))
        starts.append(rng.integers(-(L - 1), span, n))
    return Shape(span, edits, starts, bool(rng.random() < somatic_share(
        config)))


def somatic_share(config: dict) -> float:
    """The share of active regions whose variant is somatic: the somatic
    rate over all variants' (germline hets a kb, somatic SNVs a Mb)."""
    som = config["somatic_snv_per_mb"] / 1e6
    return som / (som + config["het_snp_per_kb"] / 1e3)


def _edit(rng, ref: np.ndarray, kind: str, n: int) -> np.ndarray:
    """A candidate haplotype: ``ref`` with ``n`` SNPs, or an insertion or
    a deletion of ``n`` bases."""
    if kind == "snp":
        hap = ref.copy()
        at = rng.choice(len(ref), n, replace=False)
        hap[at] = (hap[at] + rng.integers(1, 4, n)) % 4
        return hap
    at = int(rng.integers(1, len(ref) - n))
    if kind == "ins":
        return np.concatenate([ref[:at], rng.integers(0, 4, n).astype(
            np.uint8), ref[at:]])
    return np.concatenate([ref[:at], ref[at + n:]])


def mean_error_prob(L: int) -> float:
    """Mean of 10^(-q/10) over the quality profile of a read of ``L``
    bases: q = 40 - 12 offset / L less a uniform 0..9, within 2..41
    (``validate.py``'s profile, whose error probabilities are scaled to
    the stated error rate)."""
    off = np.arange(L)[:, None]
    q = np.clip(40 - (off * 12) // L - np.arange(10)[None, :], 2, 41)
    return float((10.0 ** (-q / 10.0)).mean())


def _reads(rng, src: np.ndarray, start: np.ndarray, config: dict, R: int):
    """Reads at ``start`` on ``src``, clipped to it: (codes, quals,
    lengths), padded to ``R`` columns."""
    L = config["read_len"]
    S = len(src)
    start = np.minimum(start, S - 1)
    lo = np.maximum(start, 0)
    hi = np.minimum(start + L, S)
    lens = (hi - lo).astype(np.int32)
    k = np.arange(R)[None, :]
    take = k < lens[:, None]
    codes = np.where(take, src[np.minimum(lo[:, None] + k, S - 1)], 4)
    # qualities fall along the read as sequenced (its offset from the
    # read's own start, not from the clip)
    off = (lo - start)[:, None] + k
    q = np.clip(40 - (off * 12) // L - rng.integers(0, 10, codes.shape),
                2, 41)
    p = 10.0 ** (-q / 10.0) * (config["error_rate"] / mean_error_prob(L))
    err = take & (rng.random(codes.shape) < p)
    codes = np.where(err, (codes + rng.integers(1, 4, codes.shape)) % 4,
                     codes)
    return (codes.astype(np.uint8), np.where(take, q, 0).astype(np.uint8),
            lens)


def from_variant(rng, shape: Shape, group: dict, n: int) -> np.ndarray:
    """Which of a group's ``n`` reads come from the variant's haplotype
    (1), at the group's allele fraction; the others come from the
    reference span."""
    af = group["somatic_af" if shape.somatic else "germline_af"]
    return rng.random(n) < af


def _region(rng, shape: Shape, config: dict, traffic: dict, R: int):
    """One active region of ``shape`` with its bases, edits, read
    sources and errors from ``rng``: (read codes, quals, lengths,
    haplotypes)."""
    ref = rng.integers(0, 4, shape.span).astype(np.uint8)
    haps = [ref] + [_edit(rng, ref, kind, n) for kind, n in shape.edits]
    haps = [h[:traffic["hap_len_max"]] for h in haps]
    parts = []
    for group, start in zip(config["read_groups"], shape.starts):
        alt = from_variant(rng, shape, group, len(start))
        for src, sel in ((haps[1], alt), (ref, ~alt)):
            if sel.any():
                parts.append(_reads(rng, src, start[sel], config, R))
    codes = np.concatenate([p[0] for p in parts])
    quals = np.concatenate([p[1] for p in parts])
    lens = np.concatenate([p[2] for p in parts])
    return codes, quals, lens, haps


def make_calls(config: dict, traffic: dict, seed: int) -> list[Call]:
    """The pool of calls.  The regions' sizes come from the traffic's
    ``shape_seed``, the same for every run; ``seed`` orders them and
    draws their bases, edits and errors."""
    shape_rng = np.random.default_rng(traffic["shape_seed"])
    shapes = [_shape(shape_rng, config, traffic)
              for _ in range(traffic["pool_regions"])]
    rng = np.random.default_rng(seed)
    R = config["read_len"]
    H = traffic["hap_len_max"]
    cap = traffic["max_pairs_per_call"]
    calls: list[Call] = []
    pending = []            # regions of the group being filled
    pending_pairs = 0

    def flush():
        reads = np.concatenate([r[0] for r in pending])
        quals = np.concatenate([r[1] for r in pending])
        rlens = np.concatenate([r[2] for r in pending])
        haps = [h for r in pending for h in r[3]]
        htab = np.full((len(haps), H), 4, np.uint8)
        for i, h in enumerate(haps):
            htab[i, :len(h)] = h
        hlens = np.array([len(h) for h in haps], np.int32)
        pr, ph = [], []
        roff = hoff = 0
        for codes, _, _, hs in pending:
            pr.append(np.repeat(np.arange(roff, roff + len(codes)), len(hs)))
            ph.append(np.tile(np.arange(hoff, hoff + len(hs)), len(codes)))
            roff += len(codes)
            hoff += len(hs)
        pr = np.concatenate(pr)
        ph = np.concatenate(ph)
        for s in range(0, len(pr), cap):
            calls.append(Call(reads, quals, rlens, htab, hlens,
                              pr[s:s + cap], ph[s:s + cap]))

    for k in rng.permutation(len(shapes)):
        reg = _region(rng, shapes[k], config, traffic, R)
        p = len(reg[0]) * len(reg[3])
        if pending and pending_pairs + p > cap:
            flush()
            pending, pending_pairs = [], 0
        pending.append(reg)
        pending_pairs += p
    if pending:
        flush()
    return calls


def _tiles(call: Call, dev):
    """(B, R) and (B, H) tiles of a call's pairs, on ``dev``."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    pr = t(call.pair_read.astype(np.int64))
    ph = t(call.pair_hap.astype(np.int64))
    return (t(call.reads)[pr], t(call.quals)[pr], t(call.rlens)[pr],
            t(call.haps)[ph], t(call.hlens)[ph])


class Service:
    """The likelihood service under a closed loop of caller threads."""

    unit = UNIT
    depth = 1                # a caller waits for each call

    def __init__(self, config: dict, traffic: dict, seed: int,
                 devices: list[torch.device]):
        from falcon_genome_tpu_torch.ops.pairhmm import (PairHMMParams,
                                                         pairhmm_logp_pairs)
        self.config, self.traffic = config, traffic
        self.device = devices[0]
        self.pool = make_calls(config, traffic, seed)
        R = max(int(c.rlens.max()) for c in self.pool)
        H = max(int(c.hlens.max()) for c in self.pool)
        # the bucket htc takes for these lengths (reads to a multiple of
        # 8, haplotypes of 128)
        self.params = PairHMMParams(max_read_len=(max(R, 8) + 7) // 8 * 8,
                                    max_hap_len=(max(H, 8) + 127) // 128
                                    * 128, device=self.device)
        self.entry = pairhmm_logp_pairs
        self.gaps = config["gap_open_phred"], config["gap_open_phred"], \
            config["gap_continuation_phred"]

    def units(self, i: int) -> int:
        return self.pool[i].pairs

    def submit(self, i: int):
        c = self.pool[i]
        return self.entry(c.reads, c.quals, c.rlens, c.haps, c.hlens,
                          c.pair_read, c.pair_hap, *self.gaps,
                          params=self.params)

    def complete(self, handle):
        return handle

    def release(self) -> None:
        self.entry = None

    def kernel_work(self, i: int) -> dict:
        c = self.pool[i]
        return {"k4": roofline.pairhmm_work(c.rlens[c.pair_read],
                                            c.hlens[c.pair_hap])}

    def reference(self, i: int, dtype=torch.float64) -> np.ndarray:
        read, qual, rlen, hap, hlen = _tiles(self.pool[i], self.device)
        return ref_pairhmm.log10_likelihood(
            read, qual, rlen, hap, hlen, *self.gaps,
            dtype=dtype).cpu().numpy()

    def compare(self, samples: list, control: bool = False) -> list[dict]:
        """The widest |log10 gap| between each sampled output and the
        float64 reference (with ``control``, the reference in bfloat16
        put in the program's place)."""
        refs = {}
        worst = finite = 0.0
        for i, out in samples:
            if i not in refs:
                refs[i] = self.reference(i)
            if control:
                out = self.reference(i, torch.bfloat16)
            gap = _gaps(np.asarray(out, np.float64), refs[i])
            worst = max(worst, float(gap.max(initial=0.0)))
            finite = max(finite, float(gap[np.isfinite(gap)].max(
                initial=0.0)))
        checks = [{"name": "logp_gap_max", "value": worst,
                   "limit": self.traffic["limit_logp_gap"]}]
        if control:     # the control's gap where it did not underflow
            checks.append({"name": "logp_gap_max_finite", "value": finite,
                           "limit": self.traffic["limit_logp_gap"]})
        return checks


def _gaps(out: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """|out - ref| per pair; 0 where both are -inf, inf where one is not
    a number."""
    if out.shape != ref.shape:
        return np.array([np.inf])
    d = np.where(out == ref, 0.0, np.abs(out - ref))
    return np.where(np.isnan(d), np.inf, d)

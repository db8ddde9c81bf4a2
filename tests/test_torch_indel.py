"""The port's ``indel`` stage against the JAX package's, on the CPU.

On the simulations of ``tests/test_germline_indel.py`` (reads holding a
deletion but aligned as mismatch-dense ``80M``, over clean coverage) and a
cluster of such loci whose active stretch is longer than the columnar
path's 384-column window, both packages realign the same records:

* the record path ``_realign_interval`` (one Smith-Waterman call per
  target at R a multiple of 32, W a multiple of 128): positions, CIGARs
  and ``OC`` tags equal;
* the columnar path ``_realign_columns`` (one window-gather call at
  160 x 384): every column array equal, and equal to the record path;
* ``indel`` through both CLIs: BAMs record-equal with tags.

Targets are active regions split at 300 bases, so no gathered window
reaches W = 384; the gather entry points refuse one that would.
"""
import dataclasses

import numpy as np
import pytest
import torch

from falcon_genome_tpu import cli as jcli
from falcon_genome_tpu.config import Config, Machine
from falcon_genome_tpu.io.bam import write_bam
from falcon_genome_tpu.io.columns import RecordColumns as JCols
from falcon_genome_tpu.io.dna import decode_seq
from falcon_genome_tpu.io.fasta import write_fasta
from falcon_genome_tpu.io.sam import SamHeader, SamRecord, cigar_from_str
from falcon_genome_tpu.ops.sw_ref import SWParams as JSWParams
from falcon_genome_tpu.stages import indel as JI
from falcon_genome_tpu.utils.compare import compare_bam
from falcon_genome_tpu_torch import cli as tcli
from falcon_genome_tpu_torch import convert
from falcon_genome_tpu_torch.io.bam import read_bam as t_read_bam
from falcon_genome_tpu_torch.io.sam import cigar_to_str
from falcon_genome_tpu_torch.models.activeregion import (
    ActiveRegionParams, regions_from_activity)
from falcon_genome_tpu_torch.ops import smith_waterman as TS
from falcon_genome_tpu_torch.ops.sw_ref import SWParams
from falcon_genome_tpu_torch.stages import indel as TI

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _sloppy(chrom, loci, name0=0):
    """Per locus (position, gap): reads every 5 bp over the 50 bp before
    it holding a ``gap``-base deletion but aligned as 80M, and clean 80M
    reads every 10 bp over 200 bp around it (the reference tests'
    pattern)."""
    recs, k = [], name0
    for locus, gap in loci:
        for start in range(locus - 50, locus, 5):
            seq = np.concatenate([chrom[start:start + 40],
                                  chrom[start + 40 + gap:start + 80 + gap]])
            recs.append(SamRecord(f"r{k}", 0, 0, start, 60,
                                  cigar_from_str("80M"),
                                  seq=decode_seq(seq), qual="I" * 80))
            k += 1
        for start in range(locus - 100, locus + 100, 10):
            recs.append(SamRecord(f"c{k}", 0, 0, start, 60,
                                  cigar_from_str("80M"),
                                  seq=decode_seq(chrom[start:start + 80]),
                                  qual="I" * 80))
            k += 1
    recs.sort(key=lambda r: r.pos)
    return recs


def _sim(name):
    if name == "one_locus":        # test_misaligned_read_rewritten
        chrom = np.random.default_rng(9).integers(0, 4, 2000).astype(
            np.uint8)
        return chrom, _sloppy(chrom, [(1000, 4)])
    chrom = np.random.default_rng(5).integers(0, 4, 4000).astype(np.uint8)
    if name == "three_loci":       # test_columns_match_record_path
        return chrom, _sloppy(chrom, [(800, 4), (2000, 3), (3100, 5)])
    # five loci 90 bp apart: one active stretch of ~500 bases
    return chrom, _sloppy(chrom, [(1500 + 90 * i, 3 + i % 3)
                                  for i in range(5)])


SIMS = ["one_locus", "three_loci", "cluster"]


def _key(r):
    return (r.qname, r.pos, cigar_to_str(r.cigar), r.get_tag("OC"))


@pytest.mark.parametrize("sim", SIMS)
def test_realign_interval_matches_reference(sim):
    chrom, recs = _sim(sim)
    jrecs = JCols.from_records(recs).to_records()
    n_ref = JI._realign_interval(jrecs, chrom, 0, len(chrom), JSWParams())
    trecs = convert.sam_records(JCols.from_records(recs).to_records())
    n_port = TI._realign_interval(trecs, chrom, 0, len(chrom), SWParams(),
                                  device=CPU)
    assert n_port == n_ref > 0
    assert [_key(r) for r in trecs] == [_key(r) for r in jrecs]
    assert any("D" in cigar_to_str(r.cigar) and r.get_tag("OC")
               for r in trecs if r.qname.startswith("r"))


@pytest.mark.parametrize("sim", SIMS)
def test_realign_columns_matches_reference(sim):
    """Every column of the realigned records is the reference's; on the
    sims of the reference's own test the record path agrees too."""
    chrom, recs = _sim(sim)
    jcols = JCols.from_records(recs)
    tcols = convert.record_columns(jcols)
    n_ref = JI._realign_columns(jcols, chrom, 0, len(chrom), JSWParams())
    n_port = TI._realign_columns(tcols, chrom, 0, len(chrom), SWParams(),
                                 device=CPU)
    assert n_port == n_ref > 0
    for f in dataclasses.fields(tcols):
        a, b = getattr(jcols, f.name), getattr(tcols, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    if sim != "cluster":
        trecs = convert.sam_records(JCols.from_records(recs).to_records())
        TI._realign_interval(trecs, chrom, 0, len(chrom), SWParams(),
                             device=CPU)
        assert [_key(r) for r in tcols.to_records()] == \
            [_key(r) for r in trecs]


def test_targets_never_exceed_the_window(monkeypatch):
    """The cluster's active stretch is longer than 384 bases, yet every
    target is at most 300 (active regions split at ``max_region``), so
    the columnar path's windows fit its 384 columns."""
    chrom, recs = _sim("cluster")
    cols = convert.record_columns(JCols.from_records(recs))
    events, depth = TI._activity_columns(cols, chrom, 0, len(chrom))
    params = ActiveRegionParams(threshold=0.05, pad=40)
    whole = regions_from_activity(
        events, depth, 0, len(chrom),
        dataclasses.replace(params, max_region=10_000))
    assert max(hi - lo for lo, hi in whole) > 384
    targets = regions_from_activity(events, depth, 0, len(chrom), params)
    assert max(hi - lo for lo, hi in targets) <= 300
    seen = []
    real = TS.sw_extend_gather

    def spy(*args):
        seen.append((int(np.max(args[6])), args[8].max_win_len))
        return real(*args)
    monkeypatch.setattr(TI, "sw_extend_gather", spy)
    assert TI._realign_columns(cols, chrom, 0, len(chrom), SWParams(),
                               device=CPU) > 0
    assert len(seen) == 1 and seen[0][0] <= 300 and seen[0][1] == 384


def test_gather_refuses_windows_longer_than_the_bucket():
    """A gathered window longer than W would be swept past column W by the
    reference and not by the kernels: the entry points refuse it, and the
    plain sweep, like K2, stops at W."""
    rng = np.random.default_rng(2)
    genome = rng.integers(0, 4, 2000).astype(np.uint8)
    g = TS.device_genome(genome, CPU)
    reads = genome[100:164][None].copy()
    r8 = TS.device_reads(reads, CPU)
    one = np.zeros(1, np.int32)
    rl, st, wl = np.full(1, 64, np.int32), np.full(1, 80, np.int32), \
        np.full(1, 200, np.int32)
    bucket = TS.SWBucket(64, 128, CPU)
    for call in (
            lambda: TS.sw_extend_gather(r8, one, one, rl, g, st, wl,
                                        SWParams(), bucket),
            lambda: TS.sw_score_gather(r8, one, one, rl, g, st, wl,
                                       SWParams(), bucket),
            lambda: TS.sw_extend_win_dispatch(reads, rl, g, st, wl,
                                              SWParams(), bucket)):
        with pytest.raises(ValueError, match="exceeds the bucket"):
            call()
    read = torch.from_numpy(reads.astype(np.int8))
    win = torch.from_numpy(genome[None, 80:208].astype(np.int8))
    cut = TS.sw_full(read, torch.tensor([64], dtype=torch.int32), win,
                     torch.tensor([128], dtype=torch.int32), SWParams(), 192)
    longer = TS.sw_full(read, torch.tensor([64], dtype=torch.int32), win,
                        torch.tensor([200], dtype=torch.int32), SWParams(),
                        192)
    for a, b in zip(cut, longer):
        assert torch.equal(a, b)


def test_cli_indel_matches_reference(tmp_path, monkeypatch):
    """``indel`` through both CLIs (two shards) on the one-locus sim: the
    realigned BAMs are record-equal, tags included."""
    import falcon_genome_tpu.config as jconfig
    import falcon_genome_tpu_torch.config as tconfig
    c = Config(machine=Machine(8, 16), environ={}, load_files=False)
    c.set("gatk.ncontigs", 2)
    monkeypatch.setattr(jconfig, "init", lambda: c)
    monkeypatch.setattr(tconfig, "init", lambda: convert.config(c))
    chrom, recs = _sim("one_locus")
    write_fasta(tmp_path / "ref.fa", {"chr1": decode_seq(chrom)})
    bam = tmp_path / "in.bam"
    write_bam(bam, SamHeader(contigs=[("chr1", len(chrom))]), recs)
    out = {}
    for name, main, pre in (("ref", jcli.main, []),
                            ("port", tcli.main, ["--device", "cpu"])):
        out[name] = str(tmp_path / f"{name}.bam")
        assert main([*pre, "indel", "-r", str(tmp_path / "ref.fa"),
                     "-i", str(bam), "-o", out[name], "-f"]) == 0
    d = compare_bam(out["ref"], out["port"], compare_tags=True)
    assert d.equivalent and d.matching == len(recs)
    _, got = t_read_bam(out["port"])
    assert any(r.get_tag("OC") for r in got if r.qname.startswith("r"))

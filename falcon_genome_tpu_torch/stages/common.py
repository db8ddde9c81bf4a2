"""Shared stage plumbing: reference/index loading, shard partitioning.

Port of ``falcon_genome_tpu/stages/common.py``."""
from __future__ import annotations

import logging
import os
from pathlib import Path

import numpy as np

from ..aligner import IndexParams, MinimizerIndex
from ..config import Config
from ..io.fasta import FastaFile
from ..io.intervals import Interval, split_equal_bp
from ..io.sam import SamHeader, SamRecord
from ..utils.common import check_input

log = logging.getLogger("falcon_genome_tpu")

_FASTA_CACHE: dict[str, FastaFile] = {}
_INDEX_CACHE: dict[str, MinimizerIndex] = {}


def load_fasta(ref_path: str) -> FastaFile:
    ref_path = check_input(ref_path)
    if ref_path not in _FASTA_CACHE:
        _FASTA_CACHE[ref_path] = FastaFile(ref_path)
    return _FASTA_CACHE[ref_path]


def load_index(ref_path: str, params: IndexParams = IndexParams()
               ) -> MinimizerIndex:
    """Minimizer index with an on-disk cache next to the reference
    (the analog of bwa's .bwt/.pac index files)."""
    ref_path = check_input(ref_path)
    key = f"{ref_path}:{params.k}:{params.w}"
    if key in _INDEX_CACHE:
        return _INDEX_CACHE[key]
    cache = Path(f"{ref_path}.fgidx-k{params.k}w{params.w}.npz")
    fa = load_fasta(ref_path)
    if cache.exists() and cache.stat().st_mtime >= Path(ref_path).stat().st_mtime:
        z = np.load(cache)
        idx = MinimizerIndex.__new__(MinimizerIndex)
        idx.params = params
        idx.contig_names = [c.name for c in fa.dict]
        idx.contig_codes = [fa.contig_codes(n) for n in idx.contig_names]
        idx.contig_lengths = [len(c) for c in idx.contig_codes]
        idx.offsets = z["offsets"]
        idx.genome = z["genome"]
        idx.hashes = z["hashes"]
        idx.positions = z["positions"]
        idx.strands = z["strands"]
    else:
        idx = MinimizerIndex.from_fasta(fa, params)
        # written aside and renamed into place: a process that starts
        # while another writes the cache (one per process under
        # tpu.dist.*) reads a whole file or none
        tmp = cache.with_name(f"{cache.stem}.{os.getpid()}.tmp.npz")
        np.savez(tmp, offsets=idx.offsets, genome=idx.genome,
                 hashes=idx.hashes, positions=idx.positions,
                 strands=idx.strands)
        os.replace(tmp, cache)
        log.info("built aligner index → %s", cache)
    _INDEX_CACHE[key] = idx
    return idx


def load_long_index(ref_path: str, params: IndexParams) -> MinimizerIndex:
    """Long-read index: probe a prebuilt ``.mmi.npz`` next to the
    reference first (the reference's .mmi swap, Minimap2Worker.cpp
    check()), else build/cache at the long-read k/w via load_index."""
    ref_path = check_input(ref_path)
    for cand in (Path(ref_path).with_suffix(".mmi.npz"),
                 Path(str(ref_path) + ".mmi.npz")):
        if cand.exists():
            key = f"{cand}"
            if key not in _INDEX_CACHE:
                log.info("loading prebuilt long-read index %s", cand)
                _INDEX_CACHE[key] = MinimizerIndex.load(cand)
            return _INDEX_CACHE[key]
    return load_index(ref_path, params)


def interval_shards(conf: Config, fa: FastaFile) -> list[list[Interval]]:
    """The P1 sharding plan (gatk.ncontigs equal-bp shards)."""
    return split_equal_bp(fa.dict, conf.get("gatk.ncontigs"),
                          conf.get("gatk.skip_pseudo_chr"))


def header_from_fasta(fa: FastaFile, read_groups=None,
                      sort_order="coordinate") -> SamHeader:
    return SamHeader(
        contigs=[(c.name, c.length) for c in fa.dict],
        read_groups=read_groups or [],
        programs=[{"ID": "falcon-genome-tpu", "PN": "falcon-genome-tpu"}],
        sort_order=sort_order)


# coordinate-column cache: stages filter the SAME record list once per
# shard (ncontigs times), so evaluating python record properties per
# (record, shard) pair is O(N·shards) interpreter work — memoize the
# columns per list and do the overlap test vectorized
_COLUMN_CACHE: dict[int, tuple] = {}


def _record_columns(records: list[SamRecord]):
    key = id(records)
    ent = _COLUMN_CACHE.get(key)
    if ent is not None and ent[0] is records:
        return ent[1]
    n = len(records)
    tid = np.empty(n, np.int32)
    pos = np.empty(n, np.int64)
    end = np.empty(n, np.int64)
    mapped = np.empty(n, bool)
    for i, r in enumerate(records):
        u = r.is_unmapped
        mapped[i] = not u
        tid[i] = r.tid
        pos[i] = r.pos
        end[i] = r.pos if u else r.end_pos
    cols = (tid, pos, end, mapped)
    _COLUMN_CACHE[key] = (records, cols)
    while len(_COLUMN_CACHE) > 4:                 # bound retained lists
        _COLUMN_CACHE.pop(next(iter(_COLUMN_CACHE)))
    return cols


def records_in_shard(records: list[SamRecord], shard: list[Interval],
                     header: SamHeader) -> list[SamRecord]:
    """Records overlapping any interval of a shard (the -L intersection)."""
    if not records:
        return []
    tid, pos, end, mapped = _record_columns(records)
    m = np.zeros(len(records), bool)
    for iv in shard:
        t = header.tid(iv.contig)
        m |= (tid == t) & (pos < iv.end) & (end > iv.start - 1)
    m &= mapped
    return [records[i] for i in np.flatnonzero(m)]

"""Shared stage plumbing: reference/index loading, shard partitioning.

Port of ``falcon_genome_tpu/stages/common.py`` (short-read index only)."""
from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from ..aligner import IndexParams, MinimizerIndex
from falcon_genome_tpu.config import Config
from falcon_genome_tpu.io.fasta import FastaFile
from falcon_genome_tpu.io.intervals import Interval, split_equal_bp
from falcon_genome_tpu.io.sam import SamHeader
from falcon_genome_tpu.utils.common import check_input

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
        np.savez(cache, offsets=idx.offsets, genome=idx.genome,
                 hashes=idx.hashes, positions=idx.positions,
                 strands=idx.strands)
        log.info("built aligner index → %s", cache)
    _INDEX_CACHE[key] = idx
    return idx


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

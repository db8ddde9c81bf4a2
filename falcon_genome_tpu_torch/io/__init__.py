"""I/O layer: genomics format codecs and the genome interval sharders.

This is the TPU build's L2 (SURVEY.md §7): where the reference shells out to
samtools/bgzip/tabix and parses ``.dict``/``.fai`` sidecars
(src/config.cpp:426-467), we provide in-repo codecs that decode straight into
batched numpy arrays ready for device upload.

Hot-path codecs have a C++ twin in ``native/`` (see ``io.native_ext``); every codec also has a pure-Python implementation that is the
correctness reference and the fallback.
"""
from .dna import (
    BASE_A, BASE_C, BASE_G, BASE_T, BASE_N,
    encode_seq, decode_seq, revcomp_codes, encode_seq_np,
)
from .fasta import FastaFile, ReferenceDict, write_fai, write_dict
from .fastq import FastqReader, read_fastq
from .intervals import (
    Interval,
    parse_interval,
    read_interval_list,
    write_interval_list,
    split_equal_bp,
    split_ref_round_up,
    split_interval_file,
    intersect_intervals,
)

__all__ = [
    "BASE_A", "BASE_C", "BASE_G", "BASE_T", "BASE_N",
    "encode_seq", "decode_seq", "revcomp_codes", "encode_seq_np",
    "FastaFile", "ReferenceDict", "write_fai", "write_dict",
    "FastqReader", "read_fastq",
    "Interval", "parse_interval", "read_interval_list", "write_interval_list",
    "split_equal_bp", "split_ref_round_up", "split_interval_file",
    "intersect_intervals",
]

"""Likelihood calls as the port's HaplotypeCaller sends them for reads
recalibrated by GATK 3's BQSR, which carry BI/BD tags.

The calls are ``gen/likelihood.py``'s (``make_calls``, unchanged): at a
given seed the same pairs as the ``likelihood`` generator's.  To them
this generator adds, for every unique read of a call, its insertion (BI)
and deletion (BD) phreds, from a stream of the seed of their own, by the
configuration's ``indel_quals`` model: per read a base value drawn
uniformly from ``base_min``..``base_max``, less ``per_homopolymer_base``
for each base of the homopolymer run that ends at a base beyond its
first ``homopolymer_free``, floored at ``floor``; BI and BD drawn apart.
The tables are (NR, R') uint8, phred 0 past each read, as the
qualities are.

The program's entry is ``ops.pairhmm.pairhmm_logp_pairs`` with the two
tables and the constant gap continuation, as ``models/haplotypecaller.py``
``_likelihoods_multi`` calls it for such reads (host tables, gathers on
the device, kernel K5, results back on the host).  A program whose entry
takes no tables cannot run the cell: the service raises ImportError and
the run exits without a result.  The check recomputes every pair of a
sample of the window's calls with ``reference/pairhmm.py``'s recurrence,
given the pairs' BI/BD planes (one transition a read row), in float64
on the card, a call at a time, and compares the widest gap in log10
likelihood.
"""
from __future__ import annotations

import numpy as np
import torch

from gen import likelihood
from reference import pairhmm as ref_pairhmm
import roofline_pb

UNIT = likelihood.UNIT
STREAM = 0x42494244     # the BI/BD tables' stream of the seed ("BIBD")


def homopolymer_runs(codes: np.ndarray) -> np.ndarray:
    """(NR, R') the length of the run of equal bases that ends at each
    base of each read."""
    k = np.arange(codes.shape[1], dtype=np.int16)
    new = np.ones(codes.shape, bool)       # a base that starts a run
    new[:, 1:] = codes[:, 1:] != codes[:, :-1]
    return k - np.maximum.accumulate(np.where(new, k, np.int16(0)),
                                     axis=1) + np.int16(1)


def indel_tables(reads: np.ndarray, rlens: np.ndarray, rng,
                 model: dict) -> tuple[np.ndarray, np.ndarray]:
    """The reads' (BI, BD) phred tables, (NR, R') uint8, 0 past each
    read, by ``model`` (the configuration's ``indel_quals``)."""
    NR, R = reads.shape
    i16 = np.int16
    cut = i16(model["per_homopolymer_base"]) * np.maximum(
        homopolymer_runs(reads) - i16(model["homopolymer_free"]), i16(0))
    outside = np.arange(R)[None, :] >= rlens[:, None]
    out = []
    for _ in ("BI", "BD"):
        base = rng.integers(model["base_min"], model["base_max"] + 1, NR)
        q = np.maximum(base.astype(i16)[:, None] - cut, i16(model["floor"]))
        q[outside] = 0
        out.append(q.astype(np.uint8))
    return out[0], out[1]


def pool_tables(pool: list, seed: int, model: dict) -> list[tuple]:
    """Each call's (BI, BD) tables: one draw for each unique read table
    (the calls cut from one group of regions share theirs), in the
    pool's order, from the seed's own stream."""
    rng = np.random.default_rng([seed, STREAM])
    made: dict[int, tuple] = {}
    out = []
    for c in pool:
        key = id(c.reads)
        if key not in made:
            made[key] = indel_tables(c.reads, c.rlens, rng, model)
        out.append(made[key])
    return out


def require_tables(entry) -> None:
    """Raise ImportError where the program's entry takes no gap-open
    tables (an older program): a call of one pair on the CPU."""
    from falcon_genome_tpu_torch.ops.pairhmm import PairHMMParams
    codes = np.zeros((1, 8), np.uint8)
    table = np.full((1, 8), 45, np.uint8)
    one = np.array([8], np.int32)
    try:
        entry(codes, table, one, codes, one, np.zeros(1, np.int64),
              np.zeros(1, np.int64), table, table, 10,
              params=PairHMMParams(8, 8, torch.device("cpu")))
    except (TypeError, ValueError) as e:
        raise ImportError("the program's pairhmm_logp_pairs takes no "
                          f"gap-open tables ({e})") from e


class Service(likelihood.Service):
    """The likelihood service with BI/BD tables, under a closed loop of
    caller threads."""

    def __init__(self, config: dict, traffic: dict, seed: int,
                 devices: list[torch.device]):
        super().__init__(config, traffic, seed, devices)
        require_tables(self.entry)
        self.gcp = config["gap_continuation_phred"]
        self.tables = pool_tables(self.pool, seed, config["indel_quals"])

    def submit(self, i: int):
        c = self.pool[i]
        ins, dels = self.tables[i]
        return self.entry(c.reads, c.quals, c.rlens, c.haps, c.hlens,
                          c.pair_read, c.pair_hap, ins, dels, self.gcp,
                          params=self.params)

    def kernel_work(self, i: int) -> dict:
        c = self.pool[i]
        return {"k5": roofline_pb.pairhmm_pb_work(c.rlens[c.pair_read],
                                                  c.hlens[c.pair_hap])}

    def reference(self, i: int, dtype=torch.float64) -> np.ndarray:
        c = self.pool[i]
        read, qual, rlen, hap, hlen = likelihood._tiles(c, self.device)
        pr = torch.from_numpy(c.pair_read.astype(np.int64)).to(self.device)
        ins, dels = (torch.from_numpy(t).to(self.device)[pr]
                     for t in self.tables[i])
        return ref_pairhmm.log10_likelihood(
            read, qual, rlen, hap, hlen, ins, dels, self.gcp,
            dtype=dtype).cpu().numpy()

"""HaplotypeCaller port vs the JAX reference on the reference's simulated
pileups (het SNP, hom deletion, clean data, gVCF blocks): the same VCF
records from ``call_interval``."""
import numpy as np
import pytest
import torch

from falcon_genome_tpu.io.dna import decode_seq
from falcon_genome_tpu.io.sam import SamRecord, cigar_from_str
from falcon_genome_tpu.models import haplotypecaller as JH
from falcon_genome_tpu.models.activeregion import ActiveRegionParams
from falcon_genome_tpu.models.assembly import AssemblyParams
from falcon_genome_tpu_torch import convert
from falcon_genome_tpu_torch.models import haplotypecaller as TH

torch.set_num_threads(1)


def simulate_reads(hap1, hap2, rng, n=60, read_len=80, qual=35):
    """Reads sampled evenly from two haplotypes, with varied qualities."""
    records = []
    for i in range(n):
        hap = hap1 if i % 2 == 0 else hap2
        pos = int(rng.integers(0, len(hap) - read_len))
        q = "".join(chr(33 + qual - int(x)) for x in
                    rng.integers(0, 15, read_len))
        records.append(SamRecord(
            f"r{i}", 0, 0, pos, 60, cigar_from_str(f"{read_len}M"),
            seq=decode_seq(hap[pos:pos + read_len]), qual=q))
    return records


def _case(name, rng):
    ref = rng.integers(0, 4, 600).astype(np.uint8)
    if name == "het_snp":
        alt = ref.copy()
        alt[300] = (alt[300] + 1) % 4
        return ref, simulate_reads(ref, alt, rng, n=80)
    if name == "hom_del":
        alt = np.concatenate([ref[:300], ref[306:]])
        return ref, simulate_reads(alt, alt, rng, n=80)
    if name == "het_ins":
        alt = np.concatenate([ref[:250], ref[100:104], ref[250:]])
        return ref, simulate_reads(ref, alt, rng, n=80)
    return ref, simulate_reads(ref, ref, rng, n=60)


@pytest.mark.parametrize("gvcf", [False, True])
@pytest.mark.parametrize("name", ["het_snp", "hom_del", "het_ins", "clean"])
def test_call_interval_matches_reference(name, gvcf):
    ref, recs = _case(name, np.random.default_rng(len(name)))
    jp = JH.HTCParams(assembly=AssemblyParams(kmer_sizes=(15, 21)),
                      active=ActiveRegionParams(threshold=0.02),
                      emit_gvcf=gvcf)
    want = JH.HaplotypeCaller(jp).call_interval(recs, ref, "chr1", 0, 600)
    got = TH.HaplotypeCaller(
        convert.htc_params(jp, torch.device("cpu"))).call_interval(
        convert.sam_records(recs), ref, "chr1", 0, 600)
    assert [vars(g) for g in got] == [vars(w) for w in want]
    if name != "clean":
        assert any(not v.is_gvcf_block for v in got)

"""The reference's PairHMM bits, kept in ``tests/data/``.

The fixture, ``pairhmm_reference_bits.npz``, holds 128 seeded pairs at
HaplotypeCaller's 160/384 bucket (``edge_pairs`` with the sweep's edges,
then 16 quality-0 rescue pairs that only the rescale keeps finite, the
last one subnormal), BI/BD-like transition planes for them, and the
log10 likelihoods the reference's ``_pairhmm_jax`` gives for them with
45/45/10 (kernel K4's route) and with the planes (K5's), as float32
bits. ``chip_smoke.py`` runs K4 and K5 on the card on these inputs and
requires these bits; this file regenerates them from the reference so
that the fixture cannot go stale, and holds the port's plain version to
them.

XLA's code for the reference depends on the host's instruction set: with
FMA3 (AVX2, AVX-512) it fuses the multiply-adds the port copies; built
for AVX or SSE4.2 without FMA (``XLA_FLAGS=--xla_cpu_max_isa=AVX``) 43 of
1020 finite pairs of ``make_pairs(7, 1024, 160, 384)`` differ.  The
fixture was made on an x86-64 host with AVX-512 (AVX2 gives the same
bits); the regeneration runs where the host has FMA3.

To rewrite the fixture after a change of the reference itself:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_pairhmm_fixture.py
"""
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_kernels import (  # noqa: E402
    DEL, GCP, INS, edge_pairs, indel_planes, rescale_pairs)
from torch_parity import assert_logp_bits, jax_pairhmm  # noqa: E402

FIXTURE = Path(__file__).parent / "data" / "pairhmm_reference_bits.npz"
R, H = 160, 384
INPUTS = ("reads", "q", "rl", "haps", "hl", "ins", "dele", "gcp")


def fixture_inputs() -> dict:
    parts = [edge_pairs(61, 112, R, H), rescale_pairs(62, 16, R, H)]
    reads, q, rl, haps, hl = (np.concatenate(p) for p in zip(*parts))
    ins, dele, gcp = indel_planes(63, rl, R)
    return dict(reads=reads, q=q, rl=rl, haps=haps, hl=hl, ins=ins,
                dele=dele, gcp=gcp)


def reference_bits(x: dict) -> dict:
    """The reference's log10 likelihoods for the fixture's pairs."""
    common = (x["rl"][None], x["hl"][None], x["haps"].T)
    sc = jax_pairhmm(x["reads"].T, x["q"].T, INS, DEL, GCP, *common,
                     R=R, H=H)
    pb = jax_pairhmm(x["reads"].T, x["q"].T, x["ins"].T, x["dele"].T,
                     x["gcp"].T, *common, R=R, H=H)
    return dict(logp_sc=sc, logp_pb=pb)


def _host_has_fma() -> bool:
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return False
    return any(line.startswith("flags") and " fma " in f"{line} "
               for line in text.splitlines())


def test_fixture_inputs_are_the_seeded_pairs():
    saved = np.load(FIXTURE)
    x = fixture_inputs()
    for k in INPUTS:
        np.testing.assert_array_equal(saved[k], x[k], err_msg=k)
    assert saved["rl"].shape == (128,)
    sc, pb = saved["logp_sc"], saved["logp_pb"]
    # the sweep's edges, unrelated reads that floor to -inf, rescued
    # pairs finite only through the rescale, the last one subnormal
    assert np.isneginf(sc).sum() >= 2 and np.isfinite(sc[112:-1]).all()
    assert np.isneginf(sc[-1]) and np.isfinite(pb).sum() >= 100


def test_fixture_equals_the_reference():
    """The stored bits are what the reference gives today (on a host with
    FMA3, where the fixture was made)."""
    saved = np.load(FIXTURE)
    if _host_has_fma():
        for k, v in reference_bits(fixture_inputs()).items():
            assert_logp_bits(saved[k], v, min_finite=100)


def test_plain_version_equals_the_fixture():
    from falcon_genome_tpu_torch.ops import pairhmm as P
    saved = np.load(FIXTURE)
    t = {k: torch.from_numpy(saved[k]) for k in INPUTS}
    sc = P.pairhmm_sc(t["reads"], t["q"], t["rl"], t["haps"], t["hl"],
                      INS, DEL, GCP).numpy()
    pb = P.pairhmm_pb(t["reads"], t["q"], t["ins"], t["dele"], t["gcp"],
                      t["rl"], t["haps"], t["hl"]).numpy()
    assert_logp_bits(sc, saved["logp_sc"], min_finite=100)
    assert_logp_bits(pb, saved["logp_pb"], min_finite=100)


if __name__ == "__main__":
    x = fixture_inputs()
    FIXTURE.parent.mkdir(exist_ok=True)
    np.savez_compressed(FIXTURE, **x, **reference_bits(x))
    print(f"wrote {FIXTURE}")

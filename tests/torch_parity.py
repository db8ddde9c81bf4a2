"""Bit-level comparisons of the port with the JAX reference, shared by the
``test_torch_*`` files.

``jax_pairhmm`` runs the reference's ``_pairhmm_jax`` the way its entry
points (``pairhmm_logp``, ``pairhmm_logp_pairs``) run it: lanes padded to
a multiple of 128 with the entry points' padding (N codes, phred 0,
lengths 1).  XLA's code for a lane count that is not a multiple of 128
can keep a scalar tail loop that rounds the likelihood sum differently,
so a direct call on an odd batch is not what the reference computes in
its pipeline.  ``assert_logp_bits`` holds two float32 log10 arrays to the
same bits on finite lanes and the same -inf lanes.
``assert_vcf_records_equal`` compares every field of every record of two
VCF files (``benchmarks.vcf_diff.vcf_records``).
"""
import numpy as np

LANES = 128


def _pad_lanes(x, lanes, fill):
    x = np.asarray(x)
    if x.ndim == 0:
        return x
    out = np.full(x.shape[:-1] + (lanes,), fill, x.dtype)
    out[..., :x.shape[-1]] = x
    return out


def jax_pairhmm(read_t, base_q_t, ins_q, del_q, gcp, rlen, hlen, hap_t,
                *, R, H):
    """The reference's ``_pairhmm_jax`` on time-major host arrays (read_t
    (R, B), phred planes (R, B) or scalar phreds, rlen/hlen (1, B), hap_t
    (H, B)) at a lane count padded to a multiple of 128.  Returns (B,)
    float32."""
    import jax.numpy as jnp

    from falcon_genome_tpu.ops import pairhmm as J

    B = np.shape(read_t)[1]
    lanes = max(LANES, -(-B // LANES) * LANES)

    def phred(q):
        if np.ndim(q) == 0:
            return jnp.uint8(int(q))
        return jnp.asarray(_pad_lanes(q, lanes, 0))

    out = J._pairhmm_jax(
        jnp.asarray(_pad_lanes(read_t, lanes, 4)), phred(base_q_t),
        phred(ins_q), phred(del_q), phred(gcp),
        jnp.asarray(_pad_lanes(rlen, lanes, 1)),
        jnp.asarray(_pad_lanes(hlen, lanes, 1)),
        jnp.asarray(_pad_lanes(hap_t, lanes, 4)), R=R, H=H)
    return np.asarray(out)[:B]


def assert_logp_bits(got, want, min_finite=1):
    """The same -inf lanes and the same float32 bits on every finite
    lane; returns the finite mask."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert fin.sum() >= min_finite
    bad = np.flatnonzero(got.view(np.uint32)[fin] != want.view(np.uint32)[fin])
    assert bad.size == 0, (
        f"{bad.size} of {fin.sum()} finite lanes differ in their bits, "
        f"e.g. {got[fin][bad[:4]]} against {want[fin][bad[:4]]}")
    return fin


def assert_vcf_records_equal(got_path, want_path, min_records=1):
    """Two VCFs hold the same records, equal in every field (CHROM, POS,
    ID, REF, ALT, QUAL, FILTER, INFO, FORMAT and every sample's values);
    returns the number of records."""
    from falcon_genome_tpu_torch.benchmarks.vcf_diff import vcf_records

    got, want = vcf_records(got_path), vcf_records(want_path)
    assert len(want) >= min_records
    assert len(got) == len(want), (len(got), len(want))
    diff = [(g, w) for g, w in zip(got, want) if g != w]
    assert not diff, (f"{len(diff)} of {len(want)} records differ, first: "
                      f"{diff[0][0]} against {diff[0][1]}")
    return len(want)

"""The port's benchmark slice against the repository's benchmarks: kernel
K7's plain version against ``benchmarks/ablate_sw.make_kernel`` and K6's
against ``bench.bench_pallas_fma_ceiling``, both run as Pallas kernels in
interpret mode on the CPU; the port's bench entry point at tiny sizes.

Tolerances: K7 is integer arithmetic, bit-equal in every variant.  K6's
chains are the same float32 updates; the reference sums its rows in
XLA's order, the port in row order, hence rtol 1e-5.
"""
import functools
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import bench as jbench  # noqa: E402
from benchmarks import ablate_sw as jablate  # noqa: E402
from falcon_genome_tpu_torch import bench  # noqa: E402
from falcon_genome_tpu_torch.benchmarks import ablate_sw  # noqa: E402
from falcon_genome_tpu_torch.benchmarks import idle_share  # noqa: E402
from falcon_genome_tpu_torch.benchmarks import kernel_ab  # noqa: E402
from falcon_genome_tpu_torch.ops import bench_kernels as K  # noqa: E402
from falcon_genome_tpu_torch.ops import smith_waterman as S  # noqa: E402
from falcon_genome_tpu_torch.ops.sw_ref import SWParams  # noqa: E402

torch.set_num_threads(1)

VARIANTS = {"base": {}, "no_best": {"no_best": True},
            "no_mask": {"no_mask": True}, "no_window": {"no_window": True}}


def ablate_lanes(seed, B):
    """Time-major (read (R, B), rlen (1, B), win (W, B), wlen (1, B)) at
    the ablation's R and W: reads cut from their windows with 2%
    substitutions, ragged read and window lengths."""
    R, W = jablate.R, jablate.W
    rng = np.random.default_rng(seed)
    win = np.full((W, B), 4, np.int32)
    win[:400] = rng.integers(0, 4, (400, B))
    read = np.full((R, B), 4, np.int32)
    for b in range(B):
        s = rng.integers(0, 400 - 150 + 1)
        read[:150, b] = win[s:s + 150, b]
    mut = rng.random((150, B)) < 0.02
    read[:150] = np.where(mut, (read[:150] + 1) % 4, read[:150])
    rlen = rng.integers(100, R + 1, (1, B)).astype(np.int32)
    wlen = rng.integers(300, W + 1, (1, B)).astype(np.int32)
    return read, rlen, win, wlen


def _make_kernel_interpret(lanes, **kw):
    """``make_kernel`` in a ``pallas_call`` as ``ablate_sw.main`` builds
    it, interpreted on the CPU."""
    R, W, L = jablate.R, jablate.W, jablate.LANES
    B = lanes[0].shape[1]
    col = lambda rows: pl.BlockSpec(  # noqa: E731
        (rows, L), lambda b: (0, b), memory_space=pltpu.VMEM)
    call = pl.pallas_call(
        jablate.make_kernel(jnp, jax, pl, **kw), grid=(B // L,),
        in_specs=[col(R), col(1), col(W), col(1)],
        out_specs=(col(1), col(1)),
        out_shape=(jax.ShapeDtypeStruct((1, B), jnp.int32),
                   jax.ShapeDtypeStruct((1, B), jnp.int32)),
        scratch_shapes=[pltpu.VMEM((R, L), jnp.int32)] * 5, interpret=True)
    score, pos = call(*(jnp.asarray(a) for a in lanes))
    return np.asarray(score)[0], np.asarray(pos)[0]


def _lane_major(lanes):
    read, rlen, win, wlen = lanes
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in (
        read.T.astype(np.int8), rlen[0], win.T.astype(np.int8), wlen[0])]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_ablate_plain_matches_make_kernel(variant):
    lanes = ablate_lanes(1, 128)
    want_s, want_p = _make_kernel_interpret(lanes, **VARIANTS[variant])
    got_s, got_p = K.sw_score_ablate(*_lane_major(lanes), SWParams(),
                                     **VARIANTS[variant])
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    if variant == "base":
        assert (want_s > 50).all()
    if variant == "no_best":
        assert not want_p.any()


def test_ablate_base_equals_sw_score():
    """The base variant is kernel K1's function: same score and bestpos,
    here on the aligner's tie-heavy lanes as well."""
    from test_torch_kernels import sw_lanes
    for lanes in (ablate_lanes(2, 64), sw_lanes(3, 96, 200, 64)):
        args = _lane_major(lanes)
        want = S.sw_score(*args, SWParams())
        got = K.sw_score_ablate(*args, SWParams())
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_fma_ceiling_plain_matches_reference(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jbench, "B", 128)
    monkeypatch.setattr(jbench, "N_INNER", 1)
    out = {}

    def capture(loop, args, n_inner, n_outer=3):
        out["acc"] = np.asarray(loop(*args))
        return 1.0

    monkeypatch.setattr(jbench, "_timed_loop", capture)
    jbench.bench_pallas_fma_ceiling(jax, jnp)
    trips = (jbench.BUCKET_R + jbench.BUCKET_H) // 2
    assert trips == bench.fma_trips()
    # x is all ones, so every lane of the reference holds the same value:
    # 16 of its 128 lanes are enough for the plain version
    got = K.fma_ceiling(torch.ones((jbench.BUCKET_R, 16)), trips).numpy()
    np.testing.assert_allclose(got, out["acc"][:16], rtol=1e-5)
    assert K.fma_ceiling_flops(jbench.BUCKET_R, 128, trips) == \
        2.0 * 64 * trips * jbench.BUCKET_R * 128


def test_fma_plain_rounds_once():
    """K6's plain update rounds ``x * y + z`` once, as the kernel's FFMA:
    against exact rational arithmetic, and on a sum that lies just above
    a float32 midpoint, where rounding through float64 first goes wrong."""
    from fractions import Fraction

    def exact(x, y, z):
        v = Fraction(x) * Fraction(y) + Fraction(z)
        c = np.float32(float(v))
        toward = np.float32(-np.inf if Fraction(float(c)) > v else np.inf)
        lo, hi = sorted((c, np.nextafter(c, toward)))
        dlo, dhi = v - Fraction(float(lo)), Fraction(float(hi)) - v
        if dlo != dhi:
            return lo if dlo < dhi else hi
        return lo if lo.view(np.int32) % 2 == 0 else hi

    one = torch.tensor([1 + 2.0 ** -12], dtype=torch.float32)
    tiny = torch.tensor([2.0 ** -60], dtype=torch.float32)
    assert K._fma_rn(one, one, tiny).item() == 1 + 2.0 ** -11 + 2.0 ** -23
    assert (one.double() ** 2 + tiny.double()).float().item() == \
        1 + 2.0 ** -11
    rng = np.random.default_rng(4)
    x = rng.uniform(0.5, 2, 2000).astype(np.float32)
    y = (1 + rng.integers(-1024, 1024, 2000) * 2.0 ** -23).astype(np.float32)
    z = (rng.uniform(-1, 1, 2000)
         * 2.0 ** rng.integers(-60, 0, 2000)).astype(np.float32)
    got = K._fma_rn(*(torch.from_numpy(a) for a in (x, y, z))).numpy()
    want = [exact(float(a), float(b), float(c)) for a, b, c in zip(x, y, z)]
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))


TINY = dict(B=8, R_REAL=20, H_REAL=40, BUCKET_R=24, BUCKET_H=40, SW_B=8,
            SW_R_REAL=20, SW_W_REAL=40, SW_BUCKET_R=24, SW_BUCKET_W=48,
            ALIGN_GENOME=20_000, ALIGN_READS=50, PAIR_GENOME=20_000,
            PAIR_FRAGS=30, LONG_GENOME=20_000, LONG_READS=4, LONG_LEN=1500,
            GERMLINE_GENOME=6000, N_INNER=1)


def test_bench_run_gives_the_reference_keys(tmp_path, monkeypatch):
    """Every metric of the reference's JSON line that the port carries
    (the reference's Pallas ceiling drops the word ``pallas``; its TPU
    issue-slot counts are not carried over)."""
    for name, value in TINY.items():
        monkeypatch.setattr(bench, name, value)
    res = bench.run(torch.device("cpu"), [torch.device("cpu")] * 2,
                    str(tmp_path))
    assert set(res) == {"metric", "value", "unit", "vs_baseline", "extras"}
    assert res["metric"] == "pairhmm_forward_gcups"
    assert res["unit"] == "GCUPS" and res["value"] >= 0
    assert set(res["extras"]) == {
        "pairhmm_mesh_gcups", "mesh_chips", "sw_score_gcups",
        "align_reads_per_s", "align_mapped_frac", "align_pair_reads_per_s",
        "align_pair_mapped_frac", "longread_mbp_per_s",
        "fma_ceiling_gflops", "pairhmm_mfu",
        "germline_e2e_reads_per_s", "germline_e2e_sensitivity",
        "germline_e2e_extra_calls"}
    ex = res["extras"]
    assert ex["mesh_chips"] == 1 and ex["longread_mbp_per_s"] > 0
    assert ex["align_mapped_frac"] > 0.9 and ex["align_pair_mapped_frac"] > 0.9
    assert ex["germline_e2e_sensitivity"] == 1.0
    assert ex["germline_e2e_extra_calls"] == 0


def test_pairhmm_mfu_as_reference():
    assert bench.pairhmm_mfu(40.0, 2000.0) == pytest.approx(
        jbench.pairhmm_mfu(40.0, 2000.0))
    assert bench.KERNEL_FLOPS_PER_CELL == jbench.KERNEL_FLOPS_PER_CELL


def test_ablation_times_every_variant_on_cpu(monkeypatch):
    monkeypatch.setattr(ablate_sw, "B", 4)
    monkeypatch.setattr(ablate_sw, "N_INNER", 1)
    per = ablate_sw.run(torch.device("cpu"))
    assert list(per) == [name for name, _ in ablate_sw.VARIANTS]
    assert all(sec > 0 for sec in per.values())


@pytest.mark.parametrize("entry", ["bench", "ablate_sw", "kernel_ab",
                                   "idle_share"])
def test_entry_points_need_a_card(entry, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = {"bench": lambda: bench.main([]), "ablate_sw": ablate_sw.main,
          "kernel_ab": lambda: kernel_ab.main(["."]),
          "idle_share": lambda: idle_share.main([])}[entry]()
    assert rc == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_idle_share_merges_device_intervals(tmp_path):
    """Device time is the union of the device events' intervals (two
    overlapping kernels and a copy), the span the trace's first to last
    event."""
    ev = [{"ph": "X", "ts": 0, "dur": 100, "cat": "cpu_op"},
          {"ph": "X", "ts": 10, "dur": 20, "cat": "kernel"},
          {"ph": "X", "ts": 25, "dur": 10, "cat": "kernel"},
          {"ph": "X", "ts": 50, "dur": 5, "cat": "gpu_memcpy"},
          {"ph": "i", "ts": 500, "cat": "instant"}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    assert idle_share.trace_times(path) == dict(span_ms=0.1, device_ms=0.03,
                                                kernels=2)

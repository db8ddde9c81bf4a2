"""The port's multi-device layer against the JAX package, class by class
as ``tests/test_parallel.py``: mesh shapes, the sharded steps (kernel K5
on every shard), the active mesh under the stage code, the distributed
sort, and stages split over two ``gloo`` processes (``htc``,
``baserecal``, ``mutect2``, ``ug``, ``indel`` and ``align --long-reads``,
each against one process; ``indel`` also against the reference).

Port meshes are 8 shards over the CPU (a mesh may repeat a device, and
its shards then run as one piece); the reference's are its 8 virtual CPU
devices.  Tolerances: the sharded PairHMM within 1e-5 of the reference's
(as ``tests/test_parallel.py``), and bit-equal to the port's own
single-device calls; tables, orders, VCF and BAM records exactly equal.

Run as a script, this file is the worker of the two-process tests:
``python tests/test_torch_parallel.py
{htc,baserecal,mutect2,ug,indel,align} <pid>
<coordinator> <work dir>``, the coordinator ``host:port`` or
``file://<path>`` (the tests' own: process 0 binds a free port and
writes it there).
"""
import logging
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from falcon_genome_tpu_torch import convert  # noqa: E402
from falcon_genome_tpu_torch.config import Config, Machine  # noqa: E402
from falcon_genome_tpu_torch import parallel as TP  # noqa: E402
from falcon_genome_tpu_torch.parallel import mesh as TM  # noqa: E402
from falcon_genome_tpu_torch.parallel import sharded as TS  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
CPU8 = [CPU] * 8


def _jax():
    """The reference's mesh and sharded modules (imported on use, so that
    the worker processes of this file never import JAX)."""
    import jax
    from falcon_genome_tpu.parallel import mesh as JM
    from falcon_genome_tpu.parallel import sharded as JS
    devices = jax.devices()
    assert len(devices) >= 8, "conftest must force 8 virtual CPU devices"
    return JM, JS, devices[:8]


class TestMesh:
    def test_mesh_shapes(self):
        mesh = TM.make_mesh(TM.MeshSpec(data=4, region=2), CPU8)
        assert mesh.shape == {"data": 4, "region": 2}
        assert mesh.size == 8 and mesh.axis_names == ("data", "region")
        mesh1 = TM.make_mesh(TM.MeshSpec(data=-1, region=2), CPU8)
        assert mesh1.shape == {"data": 4, "region": 2}
        JM, _, devices = _jax()
        jmesh = JM.make_mesh(JM.MeshSpec(data=-1, region=2), devices)
        assert TM.make_mesh(convert.mesh_spec(jmesh), CPU8).shape == \
            dict(jmesh.shape)

    def test_bad_factorization_raises(self):
        with pytest.raises(ValueError):
            TM.make_mesh(TM.MeshSpec(data=3, region=2), CPU8)


def _mesh_pair(data, region):
    JM, JS, devices = _jax()
    return (JM.make_mesh(JM.MeshSpec(data=data, region=region), devices),
            TM.make_mesh(TM.MeshSpec(data=data, region=region), CPU8), JS)


class TestShardedSteps:
    def test_example_batch_matches_reference(self):
        _, JS, _ = _jax()
        want = convert.example_batch(JS.make_example_batch(40, 16, 24, 64),
                                     CPU)
        got = TS.make_example_batch(40, 16, 24, 64)
        assert len(got) == len(want) == 13
        for g, w in zip(got, want):
            assert g.dtype == w.dtype or g.dtype == torch.uint8
            assert np.array_equal(g.numpy(), w.numpy())

    def test_pairhmm_matches_reference(self):
        jmesh, tmesh, JS = _mesh_pair(4, 2)
        R, H, B = 16, 24, 64
        args = JS.make_example_batch(B, R, H, n_cov=8)
        want = np.asarray(JS.sharded_pairhmm_step(jmesh, R, H)(*args[:8]))
        targs = convert.example_batch(args, CPU)
        got = TS.sharded_pairhmm_step(tmesh, R, H)(*targs[:8]).numpy()
        assert np.isfinite(want).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        # every pair's result is its own: equal to one unsharded K5 call
        from falcon_genome_tpu_torch.ops.pairhmm import pairhmm_pb
        r, bq, iq, dq, gq, rl, hl, hp = targs[:8]
        np.testing.assert_array_equal(
            got, pairhmm_pb(r, bq, iq, dq, gq, rl, hp, hl).numpy())

    def test_pairhmm_scalar_transitions(self):
        """With ``scalar_trans`` every shard runs K4 (the reference's
        ``_pairhmm_sharded(..., scalar_trans=...)``, the bench's mesh
        path): equal to one unsharded K4 call, and to the reference's step
        given the same phreds as planes."""
        from falcon_genome_tpu_torch.ops.pairhmm import pairhmm_sc
        jmesh, tmesh, JS = _mesh_pair(4, 2)
        R, H, B = 16, 24, 64
        args = [np.asarray(a) for a in JS.make_example_batch(B, R, H, 8)[:8]]
        for i, q in zip((2, 3, 4), (45, 45, 10)):
            args[i] = np.full_like(args[i], q)
        want = np.asarray(JS.sharded_pairhmm_step(jmesh, R, H)(*args))
        r, bq, _, _, _, rl, hl, hp = convert.example_batch(args, CPU)
        step = TS.sharded_pairhmm_step(tmesh, R, H,
                                       scalar_trans=(45, 45, 10))
        got = step(r, bq, bq, bq, bq, rl, hl, hp).numpy()
        np.testing.assert_array_equal(
            got, pairhmm_sc(r, bq, rl, hp, hl, 45, 45, 10).numpy())
        assert np.isfinite(want).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    def test_bqsr_histogram_reduction(self):
        mesh = TM.make_mesh(TM.MeshSpec(data=8, region=1), CPU8)
        n = 8 * 100 + 3
        rng = np.random.default_rng(1)
        rg = torch.zeros(n, dtype=torch.int32)
        qual = torch.from_numpy(rng.integers(0, 40, n).astype(np.int32))
        cyc = torch.from_numpy(rng.integers(0, 100, n).astype(np.int32))
        ctx = torch.from_numpy(rng.integers(0, 16, n).astype(np.int32))
        err = torch.from_numpy((rng.random(n) < 0.1).astype(np.float32))
        obs, errs, ctx_obs, ctx_err = TS.sharded_bqsr_histogram(mesh)(
            rg, qual, cyc, ctx, err)
        assert float(obs.sum()) == n
        assert float(errs.sum()) == float(err.sum())
        assert float(ctx_obs.sum()) == n
        assert float(ctx_err.sum()) == float(err.sum())
        flat = qual.numpy() * TS.MAX_CYCLE + cyc.numpy()
        np.testing.assert_array_equal(
            obs.numpy().ravel(), np.bincount(flat, minlength=obs.numel()))
        single = TS.sharded_bqsr_histogram(TM.make_mesh(
            TM.MeshSpec(1, 1), [CPU]))(rg, qual, cyc, ctx, err)
        for a, b in zip((obs, errs, ctx_obs, ctx_err), single):
            assert torch.equal(a, b)

    def test_germline_train_step(self):
        jmesh, tmesh, JS = _mesh_pair(4, 2)
        R, H = 16, 24
        B, n_cov = 64, 512
        args = JS.make_example_batch(B, R, H, n_cov)
        jlogp, jhist = JS.germline_train_step(jmesh, R, H)(*args)
        logp, hist = TS.germline_train_step(tmesh, R, H)(
            *convert.example_batch(args, CPU))
        assert logp.shape == (B,)
        assert np.isfinite(logp.numpy()).all()
        assert float(hist.sum()) == n_cov
        np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp),
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(hist.numpy(), np.asarray(jhist))


class TestActiveMeshPipeline:
    @pytest.mark.parametrize("planes", [False, True])
    def test_pairhmm_logp_mesh_equivalence(self, planes):
        from falcon_genome_tpu_torch.ops.pairhmm import (
            PairHMMParams, pairhmm_logp)
        mesh = TM.make_mesh(TM.MeshSpec(data=4, region=2), CPU8)
        rng = np.random.default_rng(0)
        B, R, H = 37, 24, 48
        reads = rng.integers(0, 4, (B, R)).astype(np.uint8)
        haps = rng.integers(0, 4, (B, H)).astype(np.uint8)
        q = np.full((B, R), 30, np.uint8)
        gcp = np.full((B, R), 10, np.uint8) if planes else 10
        rl = rng.integers(8, R + 1, B).astype(np.int32)
        hl = rng.integers(8, H + 1, B).astype(np.int32)
        params = PairHMMParams(max_read_len=R, max_hap_len=H, device=CPU)
        with TM.use_mesh(None):
            single = pairhmm_logp(reads, q, q, q, gcp, rl, haps, hl, params)
        with TM.use_mesh(mesh):
            sharded = pairhmm_logp(reads, q, q, q, gcp, rl, haps, hl, params)
        np.testing.assert_allclose(sharded, single, rtol=0, atol=1e-5)

    @pytest.mark.parametrize("devices,n,want", [
        (["cpu"] * 4, 10, [("cpu", [(0, 10)])]),
        (["cuda:0", "cuda:1"] * 2, 10,
         [("cuda:0", [(0, 2), (5, 7)]), ("cuda:1", [(2, 5), (7, 10)])]),
        (["cuda:0", "cuda:0", "cuda:1", "cuda:1"], 10,
         [("cuda:0", [(0, 5)]), ("cuda:1", [(5, 10)])]),
        (["cuda:0", "cuda:1"] * 2, 2, [("cuda:1", [(0, 2)])]),
    ], ids=["one-device", "alternating", "pairs", "fewer-lanes"])
    def test_device_lanes_groups_shards_by_device(self, devices, n, want):
        """The mesh's lane split grouped by device: adjacent ranges of a
        device merge, empty ones drop, devices keep their first order."""
        got = TM.device_lanes([torch.device(d) for d in devices], n)
        assert got == tuple((torch.device(d), tuple(r)) for d, r in want)

    @staticmethod
    def _interleaved(devs, n):
        """Two pieces of alternating lane ranges on the CPU: the split
        of a mesh that alternates two devices."""
        r = TM.lane_splits(n, 4)
        return [(CPU, [r[0], r[2]]), (CPU, [r[1], r[3]])]

    @pytest.mark.parametrize("split", ["mesh", "interleaved"])
    def test_pairhmm_logp_pairs_mesh_equivalence(self, split, monkeypatch):
        """Pair-indexed PairHMM under a mesh: the index lanes split over
        the devices, each gets the unique reads and haplotypes; results
        bit-equal to one device's, also where a device's lanes are two
        ranges (concatenated, then put back in place)."""
        from falcon_genome_tpu_torch.ops.pairhmm import (
            PairHMMParams, pairhmm_logp, pairhmm_logp_pairs)
        mesh = TM.make_mesh(TM.MeshSpec(data=4, region=2), CPU8)
        rng = np.random.default_rng(1)
        NR, NH, R, H = 11, 5, 24, 48
        reads = rng.integers(0, 4, (NR, R - 3)).astype(np.uint8)
        quals = rng.integers(10, 41, (NR, R - 3)).astype(np.uint8)
        haps = rng.integers(0, 4, (NH, H - 5)).astype(np.uint8)
        rl = rng.integers(8, R - 2, NR).astype(np.int32)
        hl = rng.integers(8, H - 4, NH).astype(np.int32)
        pr = np.repeat(np.arange(NR), NH)
        ph = np.tile(np.arange(NH), NR)
        params = PairHMMParams(max_read_len=R, max_hap_len=H, device=CPU)
        with TM.use_mesh(None):
            single = pairhmm_logp_pairs(reads, quals, rl, haps, hl, pr, ph,
                                        45, 45, 10, params)
            expanded = pairhmm_logp(reads[pr], quals[pr], 45, 45, 10, rl[pr],
                                    haps[ph], hl[ph], params)
        if split == "interleaved":
            monkeypatch.setattr(TM, "device_lanes", self._interleaved)
        with TM.use_mesh(mesh):
            sharded = pairhmm_logp_pairs(reads, quals, rl, haps, hl, pr, ph,
                                         45, 45, 10, params)
            sharded_exp = pairhmm_logp(reads[pr], quals[pr], 45, 45, 10,
                                       rl[pr], haps[ph], hl[ph], params)
        np.testing.assert_array_equal(single, expanded)
        np.testing.assert_array_equal(sharded, single)
        np.testing.assert_array_equal(sharded_exp, single)
        assert np.isfinite(single).all()

    def test_sharded_step_interleaved_pieces(self, monkeypatch):
        """``sharded_pairhmm_step`` where a device's lanes are two ranges:
        the pieces go back in lane order, bit-equal to one call."""
        from falcon_genome_tpu_torch.ops.pairhmm import pairhmm_pb
        batch = TS.make_example_batch(24, 16, 24, 4, seed=2)
        read, bq, iq, dq, gq, rl, hl, hp = batch[:8]
        want = pairhmm_pb(read, bq, iq, dq, gq, rl, hp, hl)
        monkeypatch.setattr(TS, "device_lanes", self._interleaved)
        mesh = TM.make_mesh(TM.MeshSpec(data=4, region=1), CPU8[:4])
        got = TS.sharded_pairhmm_step(mesh, 16, 24)(*batch[:8])
        assert torch.equal(got, want)

    def test_htc_call_interval_mesh_equivalence(self):
        import __graft_entry__ as ge
        from falcon_genome_tpu_torch.models.haplotypecaller import (
            HaplotypeCaller, HTCParams)
        mesh = TM.make_mesh(TM.MeshSpec(data=4, region=2), CPU8)
        ref, records = ge._simulated_germline_records(
            np.random.default_rng(3))
        hc = HaplotypeCaller(HTCParams(device=CPU))
        with TM.use_mesh(None):
            single = hc.call_interval(records, ref, "chr1", 0, len(ref))
        with TM.use_mesh(mesh):
            sharded = hc.call_interval(records, ref, "chr1", 0, len(ref))
        assert len(single) >= 2

        def sig(recs):
            return [(r.pos, r.ref, tuple(r.alts),
                     tuple(s.get("GT") for s in r.samples)) for r in recs]
        assert sig(single) == sig(sharded)

    def test_htc_stage_under_process_mesh(self, tmp_path, monkeypatch):
        """``run_htc`` with the mesh installed process-wide (as the CLI
        does): the runner's worker threads split PairHMM batches over it,
        the four shards on the one CPU as one kernel call each (the
        single-device run's calls), and the VCF equals the single-device
        run's."""
        import falcon_genome_tpu_torch.ops.pairhmm as TPH
        from falcon_genome_tpu_torch.io.vcf import read_vcf
        _htc_world(tmp_path)
        conf = _conf(tmp_path, 4, "mesh")
        conf.set("gatk.htc.nprocs", 2)
        mesh = TM.make_mesh(TM.MeshSpec(data=4, region=1), CPU8[:4])
        calls, splits = {}, {}
        orig = TPH.pairhmm_sc
        orig_lanes = TM.device_lanes

        def run(tag, m):
            calls[tag], splits[tag] = [], []
            monkeypatch.setattr(TPH, "pairhmm_sc", lambda *a: (
                calls[tag].append(a[0].shape[0]), orig(*a))[1])
            monkeypatch.setattr(TM, "device_lanes", lambda devs, n: (
                splits[tag].append(len(devs)), orig_lanes(devs, n))[1])
            out = tmp_path / f"{tag}.vcf"
            TM.set_active_mesh(m)
            try:
                _run_stage("htc", conf, tmp_path, out)
            finally:
                TM.set_active_mesh(None)
            return [(r.pos, r.ref, tuple(r.alts), r.qual, r.samples)
                    for r in read_vcf(str(out))[1]]

        single = run("single", None)
        meshed = run("mesh", mesh)
        assert single == meshed and len(single) > 0
        assert set(splits["single"]) == {1} and set(splits["mesh"]) == {4}
        assert sorted(calls["mesh"]) == sorted(calls["single"])
        assert sum(calls["mesh"]) == sum(calls["single"])

    def test_mesh_from_conf(self):
        from falcon_genome_tpu.config import Config as JConfig
        JM, _, devices = _jax()
        jconf = JConfig(load_files=False, environ={})
        conf = convert.config(jconf)
        mesh = TM.mesh_from_conf(conf, CPU8)   # all devices on data
        assert mesh is not None and mesh.size == 8
        assert mesh.shape == dict(JM.mesh_from_conf(jconf, devices).shape)
        assert TM.mesh_from_conf(conf, [CPU]) is None
        conf.set("tpu.mesh.data", 1)
        conf.set("tpu.mesh.region", 1)
        assert TM.mesh_from_conf(conf, CPU8) is None
        conf.set("tpu.mesh.data", 2)
        conf.set("tpu.mesh.region", 2)
        assert TM.mesh_from_conf(conf, CPU8).shape == {"data": 2,
                                                       "region": 2}
        conf.set("tpu.mesh.data", 4)
        with pytest.raises(ValueError, match="exceeds"):
            TM.mesh_from_conf(conf, CPU8[:4])

    def test_use_mesh_is_thread_local(self):
        import concurrent.futures as cf
        mesh = TM.make_mesh(TM.MeshSpec(data=2, region=1), [CPU, CPU])
        TM.set_active_mesh(mesh)
        try:
            with TM.use_mesh(None):
                assert TM.get_active_mesh() is None
                with cf.ThreadPoolExecutor(1) as pool:
                    other = pool.submit(TM.get_active_mesh).result()
            assert other is mesh and TM.get_active_mesh() is mesh
        finally:
            TM.set_active_mesh(None)

    def test_accumulate_table_mesh_equivalence(self):
        from falcon_genome_tpu.bqsr import accumulate_table as j_accumulate
        from falcon_genome_tpu_torch.bqsr import accumulate_table
        mesh = TM.make_mesh(TM.MeshSpec(data=8, region=1), CPU8)
        rng = np.random.default_rng(0)
        n = 801  # not divisible by 8
        cov = {
            "rg": rng.integers(0, 2, n).astype(np.int32),
            "qual": rng.integers(0, 40, n).astype(np.int32),
            "cycle": rng.integers(0, 100, n).astype(np.int32),
            "context": rng.integers(0, 16, n).astype(np.int32),
            "is_error": (rng.random(n) < 0.1).astype(np.float32),
        }
        with TM.use_mesh(None):
            single = accumulate_table(cov, ["rg0", "rg1"])
        with TM.use_mesh(mesh):
            sharded = accumulate_table(cov, ["rg0", "rg1"])
        want = j_accumulate(cov, ["rg0", "rg1"])
        for f in ("qual_obs", "qual_err", "cycle_obs", "cycle_err",
                  "ctx_obs", "ctx_err"):
            assert np.array_equal(getattr(sharded, f), getattr(single, f))
            assert np.array_equal(getattr(sharded, f), getattr(want, f))

    def test_accumulate_table_mesh_clamps_high_quals(self):
        """Qualities at or above ``MAX_QUAL`` count in the top bin on the
        port's mesh, as in every host table.  The port clamps them before
        it picks a branch (``falcon_genome_tpu_torch/bqsr.py``
        ``accumulate_table``), so its mesh table is its single-device table
        and the reference's host table.  The reference's mesh branch does
        not clamp: its device scatter-add drops indices past the table, so
        its mesh table loses those bases and is no yardstick here."""
        from falcon_genome_tpu.bqsr import MAX_QUAL
        from falcon_genome_tpu.bqsr import accumulate_table as j_accumulate
        from falcon_genome_tpu_torch.bqsr import accumulate_table
        JM, _, _ = _jax()
        mesh = TM.make_mesh(TM.MeshSpec(data=8, region=1), CPU8)
        rng = np.random.default_rng(3)
        n = 803
        qual = rng.integers(0, 40, n)
        high = rng.random(n) < 0.2
        qual[high] = rng.integers(MAX_QUAL, MAX_QUAL + 40, int(high.sum()))
        cov = {
            "rg": rng.integers(0, 2, n).astype(np.int32),
            "qual": qual.astype(np.int32),
            "cycle": rng.integers(0, 100, n).astype(np.int32),
            "context": rng.integers(0, 16, n).astype(np.int32),
            "is_error": (rng.random(n) < 0.1).astype(np.float32),
        }
        with TM.use_mesh(mesh):
            sharded = accumulate_table(cov, ["rg0", "rg1"])
        with JM.use_mesh(None):
            want = j_accumulate(cov, ["rg0", "rg1"])
        assert want.qual_obs[:, MAX_QUAL - 1].sum() >= high.sum()
        for f in ("qual_obs", "qual_err", "cycle_obs", "cycle_err",
                  "ctx_obs", "ctx_err"):
            assert np.array_equal(getattr(sharded, f), getattr(want, f))


def _cols(rng, n):
    """The reference's ``RecordColumns`` of ``n`` records."""
    from falcon_genome_tpu.io.columns import (
        F_FLAG, F_POS, F_TID, RecordColumns)
    fixed = np.zeros((n, 12), np.int32)
    fixed[:, F_TID] = rng.integers(0, 2, n)
    fixed[:, F_POS] = rng.integers(0, 10000, n)
    fixed[::17, F_FLAG] = 4          # unmapped sort last
    fixed[::17, F_POS] = -1
    fixed[5::17, F_POS] = 0
    return RecordColumns(
        fixed=fixed, names=np.zeros(0, np.uint8),
        name_off=np.zeros(n, np.int64), cigar_ops=np.zeros(0, np.int32),
        cigar_lens=np.zeros(0, np.int32), cig_off=np.zeros(n, np.int64),
        seq=np.zeros(0, np.uint8), qual=np.zeros(0, np.uint8),
        seq_off=np.zeros(n, np.int64), tags=np.zeros(0, np.uint8),
        tag_off=np.zeros(n, np.int64), tag_len=np.zeros(n, np.int64))


class TestDistributedSort:
    MESH = TM.make_mesh(TM.MeshSpec(data=8, region=1), CPU8)

    @pytest.mark.parametrize("kind", ["uniform", "skewed", "max_value"])
    def test_global_sort_matches_numpy(self, kind):
        rng = np.random.default_rng(0)
        if kind == "uniform":
            n = 4096 + 37                  # not divisible by the shards
            pos = rng.integers(0, 1 << 32, n).astype(np.uint64)
            keys = (pos << np.uint64(24)) | np.arange(n, dtype=np.uint64)
        elif kind == "skewed":             # one bucket holds ~90%
            n = 2048
            keys = np.full(n, 42, np.uint64)
            keys[: n // 10] = rng.integers(0, 1 << 40, n // 10).astype(
                np.uint64)
        else:                              # keys equal to the pad value
            n = 1024
            keys = rng.integers(0, 1 << 40, n).astype(np.uint64)
            keys[::7] = np.uint64(0xFFFFFFFFFFFFFFFF)
            keys[1::9] = np.uint64(1 << 63)
        got = TS.distributed_sort(self.MESH, keys, axis_name="data")
        assert got.dtype == np.uint64 and len(got) == n
        assert np.array_equal(got, np.sort(keys))

    def test_mesh_coordinate_order_matches_lexsort(self):
        rng = np.random.default_rng(0)
        n = 3000
        tid = rng.integers(0, 3, n).astype(np.uint64)
        pos = rng.integers(0, 1 << 20, n).astype(np.uint32)
        pos[100:200] = pos[0]              # ties: the sort is stable
        tid[100:200] = tid[0]
        order = TS.mesh_coordinate_order(tid, pos, self.MESH)
        assert np.array_equal(order, np.lexsort((pos, tid)))
        assert TS.mesh_coordinate_order(
            np.full(4, 0xFF, np.uint64), pos[:4], self.MESH) is None

    def test_columns_coordinate_order_uses_mesh(self, monkeypatch):
        jcols = _cols(np.random.default_rng(0), 500)
        want = jcols.coordinate_order()    # the reference, no mesh
        cols = convert.record_columns(jcols)
        calls = []
        real = TS.mesh_coordinate_order
        monkeypatch.setattr(TP, "mesh_coordinate_order",
                            lambda *a: calls.append(1) or real(*a))
        single = TP.coordinate_order(cols)
        with TM.use_mesh(self.MESH):
            meshed = TP.coordinate_order(cols)
        assert calls == [1]
        assert np.array_equal(single, want)
        assert np.array_equal(meshed, want)


# ---- stages split over two gloo processes ---------------------------------

def _conf(work: Path, ncontigs: int, tag: str) -> Config:
    conf = Config(machine=Machine(2, 4), environ={}, load_files=False)
    conf.set("gatk.ncontigs", ncontigs)
    conf.set("gatk.nprocs", 1)
    conf.set("log_dir", str(work / f"log{tag}"))
    return conf


def _run_workers(kind: str, work: Path, cli: bool = False) -> list[str]:
    """Two processes of this file's worker, or of the port's CLI; both
    must exit 0 (their last lines are reported otherwise)."""
    codes, outs = _start_workers(kind, work, cli)
    tails = "\n".join(f"--- process {i} (exit {rc}), last lines:\n"
                      + "\n".join(out.splitlines()[-25:])
                      for i, (rc, out) in enumerate(zip(codes, outs)))
    for i, (rc, out) in enumerate(zip(codes, outs)):
        assert rc == 0, f"process {i} failed:\n{tails}"
        assert cli or f"DIST{kind.upper()} {i} OK" in out, tails
    return outs


def _start_workers(kind: str, work: Path, cli: bool
                   ) -> tuple[list[int], list[str]]:
    """(exit codes, outputs) of one run of the two processes.  They meet
    through a file of the work directory: process 0 binds a free port
    itself and writes its number there."""
    coord = f"file://{work / f'rendezvous-{time.time_ns()}'}"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))

    def argv(i):
        if not cli:
            return [sys.executable, __file__, kind, str(i), coord, str(work)]
        return [sys.executable, "-m", "falcon_genome_tpu_torch.cli",
                "--device", "cpu", "htc", "-r", str(work / "ref.fa"),
                "-i", str(work / "in.bam"), "-o", str(work / "dist.vcf"),
                "-v", "-f", "-O", "gatk.ncontigs=8", "-O", "gatk.nprocs=1",
                "-O", f"log_dir={work / f'log{i}'}",
                "-O", "tpu.dist.num_processes=2",
                "-O", f"tpu.dist.process_id={i}",
                "-O", f"tpu.dist.coordinator={coord}"]
    procs = [subprocess.Popen(argv(i), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, cwd=work)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


def _htc_world(work: Path) -> None:
    """12 kb, 100 bp reads every 9 bp, a het SNP every 2.2 kb."""
    from falcon_genome_tpu_torch.io.bam import write_bam
    from falcon_genome_tpu_torch.io.dna import decode_seq
    from falcon_genome_tpu_torch.io.fasta import write_fasta
    from falcon_genome_tpu_torch.io.sam import (
        SamHeader, SamRecord, cigar_from_str)
    rng = np.random.default_rng(9)
    G, L = 12_000, 100
    ref = rng.integers(0, 4, G).astype(np.uint8)
    alt = ref.copy()
    for p in np.arange(1200, G - 1200, 2200):
        alt[p] = (alt[p] + 1) % 4
    records = []
    for i, start in enumerate(range(0, G - L, 9)):
        hap = alt if i % 2 else ref
        records.append(SamRecord(
            f"r{i}", 0, 0, start, 60, cigar_from_str(f"{L}M"),
            seq=decode_seq(hap[start:start + L]), qual="I" * L))
    write_fasta(work / "ref.fa", {"chr1": decode_seq(ref)})
    write_bam(work / "in.bam", SamHeader(contigs=[("chr1", G)]), records)


def _bqsr_world(work: Path) -> None:
    """12 kb, 600 80 bp reads with 3% substitutions, one read group."""
    from falcon_genome_tpu_torch.io.bam import write_bam
    from falcon_genome_tpu_torch.io.dna import decode_seq
    from falcon_genome_tpu_torch.io.fasta import write_fasta
    from falcon_genome_tpu_torch.io.sam import (
        SamHeader, SamRecord, cigar_from_str)
    rng = np.random.default_rng(17)
    G, L = 12_000, 80
    ref = rng.integers(0, 4, G).astype(np.uint8)
    recs = []
    for i in range(600):
        pos = int(rng.integers(0, G - L))
        seq = ref[pos:pos + L].copy()
        seq = np.where(rng.random(L) < 0.03, (seq + 1) % 4, seq)
        q = rng.integers(10, 41, L)
        r = SamRecord(f"r{i}", 0, 0, pos, 60, cigar_from_str(f"{L}M"),
                      seq=decode_seq(seq),
                      qual="".join(chr(int(x) + 33) for x in q))
        r.set_tag("RG", "Z", "rgA")
        recs.append(r)
    recs.sort(key=lambda r: r.pos)
    write_fasta(work / "ref.fa", {"chr1": decode_seq(ref)})
    write_bam(work / "in.bam", SamHeader(
        contigs=[("chr1", G)], read_groups=[{"ID": "rgA", "SM": "s"}]),
        recs)


def _m2_world(work: Path) -> None:
    """12 kb at 20x; a tumor of 2400 100 bp reads, half of them carrying
    somatic SNVs at 3001 and 9001, and a normal of reference reads."""
    from falcon_genome_tpu_torch.io.bam import write_bam
    from falcon_genome_tpu_torch.io.dna import decode_seq
    from falcon_genome_tpu_torch.io.fasta import write_fasta
    from falcon_genome_tpu_torch.io.sam import (
        SamHeader, SamRecord, cigar_from_str)
    rng = np.random.default_rng(21)
    G, L = 12_000, 100
    ref = rng.integers(0, 4, G).astype(np.uint8)
    tum = ref.copy()
    for p in (3000, 9000):
        tum[p] = (tum[p] + 1) % 4
    header = SamHeader(contigs=[("chr1", G)])
    for name, hap in (("t", tum), ("n", ref)):
        recs = []
        for i in range(2400):
            pos = int(rng.integers(0, G - L))
            src = hap if i % 2 else ref
            flag = (0x10 if i % 4 >= 2 else 0) | (0x80 if i % 8 >= 4 else 0)
            recs.append(SamRecord(
                f"{name}{i}", flag, 0, pos, 60, cigar_from_str(f"{L}M"),
                seq=decode_seq(src[pos:pos + L]), qual="I" * L))
        recs.sort(key=lambda r: r.pos)
        write_bam(work / f"{name}.bam", header, recs)
    write_fasta(work / "ref.fa", {"chr1": decode_seq(ref)})


def _indel_world(work: Path) -> None:
    """12 kb; at eight loci, one in each of the 8 shards, reads every 5 bp
    over the 50 bp before the locus hold a 3-5 base deletion but are
    aligned as 80M (realignment moves them), over clean 80M reads every
    10 bp (``tests/test_torch_indel.py``'s sims)."""
    from falcon_genome_tpu_torch.io.bam import write_bam
    from falcon_genome_tpu_torch.io.dna import decode_seq
    from falcon_genome_tpu_torch.io.fasta import write_fasta
    from falcon_genome_tpu_torch.io.sam import (
        SamHeader, SamRecord, cigar_from_str)
    chrom = np.random.default_rng(5).integers(0, 4, 12_000).astype(np.uint8)
    recs, k = [], 0
    for locus, gap in ((750 + 1500 * i, 3 + i % 3) for i in range(8)):
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
    write_fasta(work / "ref.fa", {"chr1": decode_seq(chrom)})
    write_bam(work / "in.bam", SamHeader(contigs=[("chr1", len(chrom))]),
              recs)


def _long_read_world(work: Path) -> None:
    """40 kb; 16 reads of 1-3 kb at 5% errors (a third each insertions,
    deletions, substitutions), both strands (``tests/test_torch_longread.py``'s
    simulator)."""
    from falcon_genome_tpu_torch.io.dna import decode_seq, revcomp_codes
    from falcon_genome_tpu_torch.io.fasta import write_fasta
    from falcon_genome_tpu_torch.io.fastq import write_fastq
    rng = np.random.default_rng(13)
    genome = rng.integers(0, 4, 40_000).astype(np.uint8)
    reads = []
    for t in range(16):
        pos = int(rng.integers(0, len(genome) - 4000))
        src = genome[pos:pos + int(rng.integers(1000, 3000))]
        out = []
        for b in src:
            u = rng.random()
            if u < 0.05 / 3:
                out += [int(rng.integers(0, 4)), b]
            elif u < 0.1 / 3:
                continue
            elif u < 0.05:
                out.append((b + 1 + int(rng.integers(0, 3))) % 4)
            else:
                out.append(b)
        r = np.array(out, np.uint8)
        reads.append(revcomp_codes(r) if t % 2 else r)
    write_fasta(work / "ref.fa", {"chr1": decode_seq(genome)})
    write_fastq(work / "lr.fastq", [f"lr{i}" for i in range(len(reads))],
                [decode_seq(r) for r in reads], ["I" * len(r) for r in reads])


def _run_stage(kind: str, conf: Config, work: Path, out: Path) -> None:
    if kind == "mutect2":
        from falcon_genome_tpu_torch.stages.calling import run_mutect2
        run_mutect2(conf, str(work / "ref.fa"), str(work / "t.bam"),
                    str(out), normal_path=str(work / "n.bam"), force=True,
                    device=CPU)
    elif kind == "htc":
        from falcon_genome_tpu_torch.stages.calling import run_htc
        run_htc(conf, str(work / "ref.fa"), str(work / "in.bam"), str(out),
                produce_vcf=True, force=True, device=CPU)
    elif kind == "ug":
        from falcon_genome_tpu_torch.stages.calling import run_ug
        run_ug(conf, str(work / "ref.fa"), str(work / "in.bam"), str(out),
               force=True)
    elif kind == "indel":
        from falcon_genome_tpu_torch.stages.indel import run_indel
        run_indel(conf, str(work / "ref.fa"), str(work / "in.bam"),
                  str(out), force=True, device=CPU)
    elif kind == "align":
        from falcon_genome_tpu_torch.stages.align import run_align
        run_align(conf, str(work / "ref.fa"), str(out),
                  fastq1=str(work / "lr.fastq"), long_reads=True,
                  force=True, device=CPU)
    else:
        from falcon_genome_tpu_torch.stages.bqsr import run_baserecal
        run_baserecal(conf, str(work / "ref.fa"), str(work / "in.bam"),
                      str(out), force=True)


class TestRunnerOwnership:
    def test_peer_artifact_missing_is_an_error(self, tmp_path,
                                               monkeypatch):
        """Process 0 of 2 runs tasks 0 and 2; after the barrier it adopts
        task 1's artifact from disk, and a missing one fails the stage."""
        from falcon_genome_tpu_torch.pipeline import runner as R
        monkeypatch.setattr(R, "process_info", lambda: (0, 2))
        monkeypatch.setattr(R, "sync_processes", lambda tag: None)
        outs = [tmp_path / f"part-{i}" for i in range(3)]
        ran = []

        def task(i):
            ran.append((i, TM.get_active_mesh()))
            outs[i].write_text("x")
            return str(outs[i])

        mesh = TM.make_mesh(TM.MeshSpec(2, 1), [CPU, CPU])
        st = R.stage("s", [lambda i=i: task(i) for i in range(3)],
                     outputs=[str(o) for o in outs])
        with TM.use_mesh(mesh):
            with pytest.raises(R.StageError, match="peer artifact missing"):
                R.PipelineRunner("p", force=True).run_stage(st)
        assert ran == [(0, None), (2, None)]
        outs[1].write_text("x")             # the peer's artifact appears
        got = R.PipelineRunner("p", force=True).run_stage(st)
        assert got == [str(o) for o in outs]


class TestMultiProcessStage:
    @pytest.mark.parametrize("entry", ["stage", "cli"])
    def test_two_process_htc_stage(self, tmp_path, entry):
        """The runner splits the 8-shard HTC scatter round-robin over two
        gloo processes (started through ``run_htc`` or the CLI's
        ``tpu.dist.*`` options); process 0's gathered VCF is record-equal
        to a single-process run."""
        from falcon_genome_tpu_torch.io.vcf import read_vcf
        _htc_world(tmp_path)
        single = tmp_path / "single.vcf"
        _run_stage("htc", _conf(tmp_path, 8, "1p"), tmp_path, single)
        _, expect = read_vcf(str(single))
        outs = _run_workers("htc", tmp_path, cli=entry == "cli")
        for out in outs:
            assert "(4 local to process" in out
        _, got = read_vcf(str(tmp_path / "dist.vcf"))

        def key(rs):
            return [(r.contig, r.pos, r.ref, tuple(r.alts), r.qual,
                     r.samples) for r in rs]
        assert key(got) == key(expect) and len(got) > 0

    def test_two_process_baserecal_stage(self, tmp_path):
        """The baserecal scatter splits over two gloo processes; the
        primary's gathered table equals the single-process table."""
        from falcon_genome_tpu_torch.bqsr import RecalTable
        _bqsr_world(tmp_path)
        single = tmp_path / "single.recal.npz"
        _run_stage("baserecal", _conf(tmp_path, 6, "1p"), tmp_path, single)
        expect = RecalTable.load(str(single))
        outs = _run_workers("baserecal", tmp_path)
        for out in outs:
            assert "(3 local to process" in out
        got = RecalTable.load(str(tmp_path / "dist.recal.npz"))
        assert expect.qual_obs.sum() > 0
        for name in ("qual_obs", "qual_err", "cycle_obs", "cycle_err",
                     "ctx_obs", "ctx_err"):
            assert np.array_equal(getattr(got, name),
                                  getattr(expect, name)), name


    def test_two_process_mutect2_stage(self, tmp_path):
        """The mutect2 scatter (tumor and normal, 8 shards) splits over two
        gloo processes; process 0's gathered VCF is record-equal to a
        single-process run."""
        from falcon_genome_tpu_torch.io.vcf import read_vcf
        _m2_world(tmp_path)
        single = tmp_path / "single.vcf"
        _run_stage("mutect2", _conf(tmp_path, 8, "1p"), tmp_path, single)
        _, expect = read_vcf(str(single))
        outs = _run_workers("mutect2", tmp_path)
        for out in outs:
            assert "(4 local to process" in out
        _, got = read_vcf(str(tmp_path / "dist.vcf"))
        assert [vars(r) for r in got] == [vars(r) for r in expect]
        assert {r.pos for r in got if r.filter == "PASS"} >= {3001, 9001}

    def test_two_process_ug_stage(self, tmp_path):
        """``ug`` on the htc world over two gloo processes (8 shards):
        process 0's gathered VCF is record-equal to one process's."""
        from falcon_genome_tpu_torch.io.vcf import read_vcf
        _htc_world(tmp_path)
        single = tmp_path / "single.vcf"
        _run_stage("ug", _conf(tmp_path, 8, "1p"), tmp_path, single)
        _, expect = read_vcf(str(single))
        outs = _run_workers("ug", tmp_path)
        for out in outs:
            assert "(4 local to process" in out
        _, got = read_vcf(str(tmp_path / "dist.vcf"))
        assert [vars(r) for r in got] == [vars(r) for r in expect]
        assert len(got) > 0

    def test_two_process_indel_stage(self, tmp_path):
        """``indel`` over two gloo processes (8 shards, a locus whose reads
        realignment moves in each): the merged BAM is record-equal, tags
        included, to one process's and to the reference's single-process
        ``run_indel``; the parts are gone."""
        from falcon_genome_tpu.config import Config as JConfig
        from falcon_genome_tpu.config import Machine as JMachine
        from falcon_genome_tpu.stages.indel import run_indel as j_run_indel
        from falcon_genome_tpu_torch.io.bam import read_bam
        from falcon_genome_tpu_torch.utils.compare import compare_bam
        _indel_world(tmp_path)
        single = tmp_path / "single.bam"
        _run_stage("indel", _conf(tmp_path, 8, "1p"), tmp_path, single)
        jconf = JConfig(machine=JMachine(2, 4), environ={}, load_files=False)
        jconf.set("gatk.ncontigs", 8)
        jconf.set("gatk.nprocs", 1)
        jconf.set("log_dir", str(tmp_path / "logj"))
        ref = tmp_path / "ref.bam"
        j_run_indel(jconf, str(tmp_path / "ref.fa"), str(tmp_path / "in.bam"),
                    str(ref), force=True)
        outs = _run_workers("indel", tmp_path)
        for out in outs:
            assert "(4 local to process" in out
        dist = tmp_path / "dist.bam"
        _, recs = read_bam(str(dist))
        moved = [r for r in recs if r.qname.startswith("r") and
                 any(op == 2 for op, _ in r.cigar)]
        assert len(moved) >= 8 * 5
        for other in (single, ref):
            d = compare_bam(str(other), str(dist), compare_tags=True)
            assert d.equivalent and d.matching == len(recs), (other, d)
        assert not Path(str(dist) + ".parts").exists()

    def test_two_process_align_long_reads(self, tmp_path):
        """``align --long-reads`` in two gloo processes (first, so that
        both build the reference's minimizer index at once): the BAM that
        process 0 writes is record-equal, tags included, to one process's
        run, and every read is placed."""
        from falcon_genome_tpu_torch.io.bam import read_bam
        from falcon_genome_tpu_torch.utils.compare import compare_bam
        _long_read_world(tmp_path)
        outs = _run_workers("align", tmp_path)
        assert all("records →" in out for out in outs)
        single = tmp_path / "single.bam"
        _run_stage("align", _conf(tmp_path, 8, "1p"), tmp_path, single)
        dist = tmp_path / "dist.bam"
        _, recs = read_bam(str(dist))
        assert len(recs) == 16 and all(r.flag & 0x4 == 0 for r in recs)
        d = compare_bam(str(single), str(dist), compare_tags=True)
        assert d.equivalent and d.matching == 16, d

    @pytest.mark.parametrize("first", [
        "ValueError: a fault of the stage itself",
        "(3 local to process 1/2)\nConnection reset by peer"])
    def test_a_failed_worker_is_reported_at_once(self, tmp_path,
                                                 monkeypatch, first):
        """A failed process fails the pair on its first run, with both
        processes' last lines (no rerun: the rendezvous cannot lose its
        port)."""
        started = []

        def start(kind, work, cli):
            started.append(kind)
            return [0, 1], ["DISTHTC 0 OK", first]

        monkeypatch.setattr(sys.modules[__name__], "_start_workers", start)
        with pytest.raises(AssertionError, match="process 1 failed") as e:
            _run_workers("htc", tmp_path)
        assert "process 0 (exit 0)" in str(e.value)
        assert first.splitlines()[-1] in str(e.value)
        assert len(started) == 1

    def test_file_rendezvous_peer_waits_for_the_port(self, tmp_path,
                                                     monkeypatch):
        """A peer of a ``file://`` coordinator waits for process 0's port
        file, and gives up at the timeout without joining."""
        import datetime
        monkeypatch.setattr(TM, "DIST_TIMEOUT",
                            datetime.timedelta(seconds=0.3))
        path = tmp_path / "rendezvous"
        with pytest.raises(TimeoutError, match="no rendezvous port"):
            TM.distributed_initialize(f"file://{path}", 2, 1)
        assert TM.process_info() == (0, 1)


_NO_JAX = r"""
import sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError("jax is blocked in this process")
        return None

sys.meta_path.insert(0, _Block())
import torch
from falcon_genome_tpu_torch import parallel
from falcon_genome_tpu_torch.parallel import mesh, sharded
m = parallel.make_mesh(parallel.MeshSpec(2, 1), [torch.device("cpu")] * 2)
out = sharded.sharded_pairhmm_step(m, 16, 24)(
    *sharded.make_example_batch(8, 16, 24, 4)[:8])
assert out.shape == (8,)
assert not any(k == "jax" or k.startswith("jax.") for k in sys.modules)
"""


def test_parallel_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", _NO_JAX], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]


_DIST_OUT = {"baserecal": "dist.recal.npz", "indel": "dist.bam",
             "align": "dist.bam"}


def _worker(kind: str, pid: int, coordinator: str, work: Path) -> int:
    """One of the two processes: the SAME stage call in each; the runner
    splits the tasks and process 0 gathers."""
    logging.basicConfig(level=logging.INFO, stream=sys.stdout)
    conf = _conf(work, 6 if kind == "baserecal" else 8, str(pid))
    conf.set("tpu.dist.num_processes", 2)
    conf.set("tpu.dist.process_id", pid)
    conf.set("tpu.dist.coordinator", coordinator)
    assert TM.initialize_from_conf(conf, CPU) is None
    assert TM.process_info() == (pid, 2)
    out = work / _DIST_OUT.get(kind, "dist.vcf")
    try:
        _run_stage(kind, conf, work, out)
        if pid == 0:
            assert out.exists()
    finally:
        TM.shutdown()
    print(f"DIST{kind.upper()} {pid} OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1], int(sys.argv[2]), sys.argv[3],
                     Path(sys.argv[4])))

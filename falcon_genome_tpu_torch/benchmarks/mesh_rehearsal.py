"""HaplotypeCaller under a device mesh against no mesh, record-equal, at
rehearsal scale.

Port of ``benchmarks/mesh_rehearsal.py``: the whole ``run_htc`` stage
over the first ``SPAN_MB`` Mb (default 6) of the WGS rehearsal's
``dedup.bam`` (25x, hundreds of active regions a shard, streamed through
its ``.bai``), once with no mesh and once on a (data=4, region=2) mesh of
eight shards over the visible cards (``cuda:(i % count)``: eight shards
on one card, or spread over four; on the CPU eight times the CPU).  The
mesh is installed process-wide, as the CLI installs it
(``set_active_mesh``): htc's tasks run in a thread pool, and
``use_mesh``, which the JAX script used, sets the mesh of the calling
thread only.  The calls' signatures (contig, position, alleles,
genotypes) must be equal; otherwise it prints the first differences and
exits 1.

Each run's entry has its wall, its calls, its peak device memory (the
card's own), each kernel's launches in it and the distinct cards its PairHMM calls ran on (``parallel.mesh.
call_device`` runs each call whole on one card; htc's threads take the
cards in turn).  The results go to ``--out`` (default
``mesh_rehearsal.json`` beside this file).

Usage:
    python -m falcon_genome_tpu_torch.benchmarks.mesh_rehearsal
        [WORKDIR] [SPAN_MB] [--device cuda|cpu] [--out PATH]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import sys
from pathlib import Path

from .wgs_rehearsal import DEFAULT_WORK, Measured, card_label, make_conf

SPAN_MB = 6
DEFAULT_MESH_OUT = Path(__file__).with_name("mesh_rehearsal.json")


class PairHMMCards:
    """The devices that PairHMM calls ran on while a run is driven: wraps
    the K4 and K5 wrappers, where every call lands on its card, and
    launches nothing itself."""

    def __init__(self):
        self.devices: set[str] = set()

    def __enter__(self):
        from ..ops import pairhmm as P
        self.P = P
        self.real = P.pairhmm_sc, P.pairhmm_pb

        def seen(fn):
            def call(read, *a, **k):
                self.devices.add(str(read.device))
                return fn(read, *a, **k)
            return call
        P.pairhmm_sc, P.pairhmm_pb = map(seen, self.real)
        return self

    def __exit__(self, *exc):
        self.P.pairhmm_sc, self.P.pairhmm_pb = self.real


@contextlib.contextmanager
def active_mesh(mesh):
    """``mesh`` as the process-wide mesh (every thread's) inside the
    block, the previous one restored after it."""
    from ..parallel.mesh import get_active_mesh, set_active_mesh
    prev = get_active_mesh()
    set_active_mesh(mesh)
    try:
        yield mesh
    finally:
        set_active_mesh(prev)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("work", nargs="?", default=str(DEFAULT_WORK))
    ap.add_argument("span_mb", nargs="?", type=float, default=SPAN_MB)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(DEFAULT_MESH_OUT))
    args = ap.parse_args(argv)
    from .. import stages
    from ..device import resolve_device
    from ..io.fasta import FastaFile
    from ..io.vcf import read_vcf
    from ..parallel.mesh import MeshSpec, make_mesh, visible_devices
    device = resolve_device(args.device)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)

    work = Path(args.work)
    span_mb = args.span_mb
    dedup = work / "dedup.bam"
    if not dedup.exists():
        raise SystemExit(f"{dedup} missing - run wgs_rehearsal first")
    conf = make_conf(work)
    contig = FastaFile(str(work / "ref.fa")).dict.contigs[0].name
    intervals = work / f"slice{span_mb:g}.bed"
    intervals.write_text(f"{contig}\t0\t{int(span_mb * 1_000_000)}\n")

    results = {}

    def run(tag, mesh):
        out = work / f"mesh_gate_{tag}.vcf.gz"
        with Measured(device) as m, PairHMMCards() as cards, \
                active_mesh(mesh):
            stages.run_htc(conf, str(work / "ref.fa"), str(dedup),
                           str(out), produce_vcf=True,
                           intervals=str(intervals), force=True,
                           device=device)
        _, recs = read_vcf(str(out))
        sig = [(r.contig, r.pos, r.ref, tuple(r.alts),
                tuple(s.get("GT", "") for s in r.samples))
               for r in recs if not r.is_gvcf_block]
        results[tag] = {"wall_s": round(m.wall, 1), "n_calls": len(sig),
                        "peak_device_gb": m.row(0)["peak_device_gb"],
                        "launches": m.launches,
                        "pairhmm_cards": sorted(cards.devices)}
        print(f"{tag}: {m.wall:.0f}s, {len(sig)} calls, launches "
              f"{m.launches}, PairHMM on {sorted(cards.devices)}",
              flush=True)
        return sig

    visible = visible_devices(device)
    mesh = make_mesh(MeshSpec(data=4, region=2),
                     [visible[i % len(visible)] for i in range(8)])
    sig_single = run("single", None)
    sig_mesh = run("mesh8", mesh)

    equal = sig_single == sig_mesh
    results.update(equal=equal, span_mb=span_mb, card=card_label(device),
                   cards=len(visible))
    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(results, indent=1))
    print(json.dumps(results))
    if not equal:
        only_s = set(sig_single) - set(sig_mesh)
        only_m = set(sig_mesh) - set(sig_single)
        print("only single:", sorted(only_s)[:10])
        print("only mesh:", sorted(only_m)[:10])
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

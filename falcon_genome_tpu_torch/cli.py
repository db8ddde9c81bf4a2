"""CLI of the port: ``python -m falcon_genome_tpu_torch.cli [--device D] <cmd>``.

The subcommands, their options (:func:`build_parser`, a copy of the
reference's) and the exit-code policy are the reference's (helpRequest 0,
invalidParam 1, argparse error 2, fileNotFound 3, failedCommand 4,
internal error 255).  One global option is added:

  ``--device {cuda,cpu}`` (default ``cuda``) — where the kernels run.
  ``cuda`` without a card is an error (exit 1), never a move to the CPU;
  ``cpu`` runs the kernels' plain PyTorch versions.

Before a command that runs kernels, the device mesh comes up as in the
reference (``parallel.mesh.initialize_from_conf``): one process shards
over every visible card (``tpu.mesh.*``); several processes
(``-O tpu.dist.num_processes=N -O tpu.dist.process_id=i
-O tpu.dist.coordinator=host:port``, or the matching
``FCS_TPU__DIST__*`` environment variables) join one ``gloo`` group and
split each stage's tasks; process i runs on ``cuda:(i % device_count)``.

Ported: align, markdup, bqsr, htc, germline.  Every other subcommand of
the reference exits with the invalid-parameter code: not yet ported.
"""
from __future__ import annotations

import argparse
import logging
import sys

import torch

from . import __version__, config as config_mod
from .device import resolve_device
from .utils.errors import (
    FGError, HelpRequest, InvalidParam, SilentExit, exit_code_for)

log = logging.getLogger("falcon_genome_tpu")

COMMANDS = {
    "align": "align pair-end FASTQ files into a sorted BAM file",
    "markdup": "mark duplicates in a BAM file or bucket folder",
    "bqsr": "base recalibration + print reads (chained)",
    "htc": "call germline variants with the HaplotypeCaller model",
    "germline": "one-command germline pipeline (align → markdup → bqsr → htc)",
}
# commands whose stages launch kernels: they bring up the device mesh
# and the process group first (the reference's DEVICE_COMMANDS)
DEVICE_COMMANDS = {"align", "bqsr", "htc", "germline"}
NOT_PORTED = ("baserecal", "printreads", "mutect2", "indel", "joint", "ug",
              "gatk", "depth", "vcf_filter", "concat", "conf")


def print_help() -> None:
    print("Falcon Genome on PyTorch/CUDA "
          f"(falcon_genome_tpu_torch) v{__version__}")
    print("Usage: python -m falcon_genome_tpu_torch.cli "
          "[--device {cuda,cpu}] [command] <options>\n")
    print("Commands:")
    for name, desc in COMMANDS.items():
        print(f"  {name:12s} {desc}")
    print(f"\nNot yet ported: {', '.join(NOT_PORTED)}")


def _base(p: argparse.ArgumentParser, ref=True, output=True):
    if ref:
        p.add_argument("-r", "--ref", required=True, help="reference FASTA")
    if output:
        p.add_argument("-o", "--output", required=True)
    p.add_argument("-f", "--force", action="store_true",
                   help="overwrite outputs")
    p.add_argument("-O", "--option", action="append", default=[],
                   metavar="KEY=VALUE", help="config override")
    p.add_argument("--extra-options", action="append", default=[],
                   help="per-tool flag overrides, GATK-style "
                   "(e.g. \"-ERC NONE -stand_call_conf 30\"); "
                   "override-wins vs stage defaults")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="falcon-genome-tpu", add_help=False)
    sub = ap.add_subparsers(dest="command")

    p = sub.add_parser("align")
    _base(p)
    p.add_argument("-1", "--fastq1")
    p.add_argument("-2", "--fastq2")
    p.add_argument("-F", "--sample-sheet")
    p.add_argument("-S", "--sample-id", default="sample")
    p.add_argument("-R", "--rg", default="rg0", help="read group id")
    p.add_argument("-L", "--library", default="lib0")
    p.add_argument("-P", "--platform", default="illumina")
    p.add_argument("--disable-merge", action="store_true")
    p.add_argument("--num-buckets", type=int, default=0)
    p.add_argument("--long-reads", action="store_true",
                   help="minimap-class long-read alignment "
                        "(gap-cost chaining, single-end records)")

    p = sub.add_parser("markdup")
    _base(p, ref=False)
    p.add_argument("-i", "--input", required=True)

    for name in ("baserecal", "printreads", "bqsr"):
        p = sub.add_parser(name)
        _base(p)
        p.add_argument("-i", "--input", required=True)
        p.add_argument("-K", "--knownSites", action="append", default=[])
        if name == "printreads":
            p.add_argument("-b", "--bqsr", required=True,
                           help="recalibration table path")

    p = sub.add_parser("htc")
    _base(p)
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-v", "--produce-vcf", action="store_true")
    p.add_argument("-L", "--intervals")
    p.add_argument("-S", "--sample-id", default="SAMPLE")

    p = sub.add_parser("mutect2")
    _base(p)
    p.add_argument("-t", "--tumor", required=True)
    p.add_argument("-n", "--normal")
    p.add_argument("-L", "--intervals")
    p.add_argument("--skip-filter", action="store_true")
    # resource surface (ref worker-mutect2.cpp:64-72)
    p.add_argument("-d", "--dbsnp", action="append", default=[])
    p.add_argument("-c", "--cosmic", action="append", default=[])
    p.add_argument("-m", "--germline")
    p.add_argument("-p", "--panels_of_normals", "--panel-of-normals",
                   dest="panels_of_normals")
    p.add_argument("--contamination_table", "--contamination-table",
                   dest="contamination_table")
    p.add_argument("-a", "--normal_name", default="NORMAL")
    p.add_argument("-b", "--tumor_name", default="TUMOR")

    p = sub.add_parser("indel")
    _base(p)
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-K", "--knownSites", action="append", default=[])

    p = sub.add_parser("joint")
    _base(p)
    p.add_argument("-i", "--input-dir", required=True)

    p = sub.add_parser("ug")
    _base(p)
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-L", "--intervals")
    p.add_argument("-S", "--sample-id", default="SAMPLE")

    p = sub.add_parser("gatk")
    p.add_argument("gatk_args", nargs=argparse.REMAINDER)

    p = sub.add_parser("depth")
    _base(p)
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-L", "--intervals")
    p.add_argument("-S", "--sample-id", default="SAMPLE")
    # ref worker-depth.cpp:29-35
    p.add_argument("-g", "--geneList", dest="gene_list")
    p.add_argument("-b", "--omitBaseOutput", dest="omit_base",
                   action="store_true", default=None,
                   help="omit per-base coverage output")
    p.add_argument("--emitBaseOutput", dest="omit_base",
                   action="store_false",
                   help="write per-base coverage (large)")
    p.add_argument("-v", "--omitIntervals", dest="omit_intervals",
                   action="store_true")
    p.add_argument("-s", "--omitSampleSummary", dest="omit_summary",
                   action="store_true")

    p = sub.add_parser("vcf_filter")
    _base(p)
    p.add_argument("-i", "--input", required=True)
    p.add_argument("--filter-expression", required=True)
    p.add_argument("--filter-name", default="FILTERED")

    p = sub.add_parser("germline")
    _base(p)
    p.add_argument("-1", "--fastq1")
    p.add_argument("-2", "--fastq2")
    p.add_argument("-F", "--sample-sheet")
    p.add_argument("-S", "--sample-id", default="sample")
    p.add_argument("-R", "--rg", default="rg0")
    p.add_argument("-v", "--produce-vcf", action="store_true")
    p.add_argument("--long-reads", action="store_true",
                   help="minimap-class long-read alignment (the fast-"
                        "germline driver's Minimap2Worker path)")

    p = sub.add_parser("concat")
    _base(p, ref=False)
    p.add_argument("-i", "--input-dir", required=True)

    sub.add_parser("conf")
    return ap


def dispatch(args: argparse.Namespace, conf, device: torch.device) -> None:
    from . import stages

    for kv in getattr(args, "option", []) or []:
        if "=" not in kv:
            raise InvalidParam(f"-O expects KEY=VALUE, got {kv!r}")
        k, v = kv.split("=", 1)
        conf.set(k, v)

    cmd = args.command
    if cmd in DEVICE_COMMANDS:
        from .parallel.mesh import initialize_from_conf, process_device
        initialize_from_conf(conf, device)
        device = process_device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
    if cmd == "align":
        stages.run_align(conf, args.ref, args.output,
                         fastq1=args.fastq1, fastq2=args.fastq2,
                         sample_sheet=args.sample_sheet,
                         sample_id=args.sample_id, read_group=args.rg,
                         platform=args.platform, library=args.library,
                         num_buckets=args.num_buckets,
                         merge=not args.disable_merge,
                         long_reads=args.long_reads, force=args.force,
                         extra_opts=args.extra_options, device=device)
    elif cmd == "markdup":
        stages.run_markdup(conf, args.input, args.output, force=args.force,
                           extra_opts=args.extra_options)
    elif cmd == "bqsr":
        stages.run_bqsr(conf, args.ref, args.input, args.output,
                        known_sites=args.knownSites, force=args.force,
                        extra_opts=args.extra_options)
    elif cmd == "htc":
        stages.run_htc(conf, args.ref, args.input, args.output,
                       produce_vcf=args.produce_vcf,
                       intervals=args.intervals, sample=args.sample_id,
                       force=args.force, extra_opts=args.extra_options,
                       device=device)
    elif cmd == "germline":
        stages.run_germline(conf, args.ref, args.output,
                            fastq1=args.fastq1, fastq2=args.fastq2,
                            sample_sheet=args.sample_sheet,
                            sample_id=args.sample_id, read_group=args.rg,
                            produce_vcf=args.produce_vcf,
                            long_reads=args.long_reads, force=args.force,
                            extra_opts=args.extra_options, device=device)
    else:
        raise InvalidParam(f"unknown command {cmd!r}")


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s] %(message)s")
    try:
        pre = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
        pre.add_argument("--device", choices=("cuda", "cpu"),
                         default="cuda")
        ns, argv = pre.parse_known_args(argv)
        if not argv or argv[0] in ("-h", "--help", "help"):
            print_help()
            return 0
        if argv[0] in NOT_PORTED:
            raise InvalidParam(f"{argv[0]}: not yet ported")
        if argv[0] not in COMMANDS:
            print_help()
            raise InvalidParam(f"unknown command {argv[0]!r}")
        conf = config_mod.init()
        args = build_parser().parse_args(argv)
        try:
            dispatch(args, conf, resolve_device(ns.device))
        finally:
            from .parallel.mesh import set_active_mesh, shutdown
            set_active_mesh(None)
            shutdown()
        return 0
    except (HelpRequest, SilentExit) as e:
        msg = str(e)
        if msg:
            print(msg, file=sys.stderr)
        return exit_code_for(e)
    except FGError as e:
        log.error("%s", e)
        return exit_code_for(e)
    except Exception as e:  # runtime_error → 255 (ref main.cpp:231-238)
        log.error("internal error: %s", e, exc_info=True)
        return 255


if __name__ == "__main__":
    sys.exit(main())

"""CLI of the port: ``python -m falcon_genome_tpu_torch.cli [--device D] <cmd>``.

The subcommands, their options and the exit-code policy are the
reference's (``falcon_genome_tpu.cli.build_parser``; helpRequest 0,
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

from falcon_genome_tpu import config as config_mod
from falcon_genome_tpu.cli import build_parser
from falcon_genome_tpu.utils.errors import (
    FGError, HelpRequest, InvalidParam, SilentExit, exit_code_for)

from . import __version__
from .device import resolve_device

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

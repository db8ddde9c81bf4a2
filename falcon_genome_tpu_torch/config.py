"""3-tier hierarchical config system with machine-aware defaults.

TPU-native re-design of the reference's config layer (src/config.cpp,
include/fcs-genome/config.h):

* dotted option keys with typed defaults          (config.cpp:271-355)
* 3-priority layering: environment variables (``FALCON_*``/``FCS_*`` prefix,
  allow-listed) > local ``./falcon-genome-tpu.conf`` > global
  ``<root>/falcon-genome-tpu.conf`` > built-in defaults (config.cpp:118-153;
  first-set-wins like boost::program_options::store)
* per-stage fallback chains, e.g. ``gatk.htc.nprocs`` falls back to
  ``gatk.nprocs`` (config.cpp:156-180, config.h:48-56)
* machine-aware auto-tuning of the default shard/worker/memory budget
  (``calc_gatk_default_config``, config.cpp:56-82) and resource sanity
  warnings (config.cpp:84-116)
* a ``conf`` subcommand dump (config.cpp:362-366).

On TPU the "procs × heap" budget of the reference becomes a host-side staging
budget (how many region shards are resident/in flight per host), and new
``tpu.*`` options control mesh shape and kernel bucketing.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import re
import sys
from pathlib import Path
from typing import Any

from .utils.errors import OptionsError

log = logging.getLogger("falcon_genome_tpu")

CONF_BASENAME = "falcon-genome-tpu.conf"
# also honored for drop-in compatibility with reference deployments
LEGACY_CONF_BASENAME = "fcs-genome.conf"
ENV_PREFIXES = ("FALCON_", "FCS_")


# ---------------------------------------------------------------------------
# machine probing + auto-tune (ref: config.cpp:56-116)
# ---------------------------------------------------------------------------

def get_sys_cpus() -> int:
    return os.cpu_count() or 1


def get_sys_memory_gb() -> int:
    """Total system memory in GB (ref: get_sys_memory reads /proc/meminfo)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    kb = int(line.split()[1])
                    return kb // (1024 * 1024)
    except OSError:
        pass
    return 8


def calc_default_worker_config(cpu_num: int, memory_gb: int) -> tuple[int, int]:
    """Auto-tune (nprocs, memory_gb_per_proc) from machine size.

    Exact semantics of the reference's ``calc_gatk_default_config``
    (config.cpp:56-82), validated against the expectation table in
    test/TestConfig.cpp:70-100: start at 32 procs × 4 GB; halve procs until
    ≤ #cpus; raise memory by 2 GB (to ≤ 8) while it still fits in
    1.05 × RAM with 2 GB headroom per proc; then halve procs until
    procs × mem ≤ 1.05 × RAM.
    """
    nprocs, memory = 32, 4
    margin = 0.05
    while nprocs > cpu_num:
        nprocs //= 2
    while nprocs * (memory + 2) < memory_gb * (1 + margin) and memory < 8:
        memory += 2
    while nprocs * memory > memory_gb * (1 + margin):
        nprocs //= 2
    return nprocs, memory


# ---------------------------------------------------------------------------
# option table
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Option:
    name: str
    type: type
    default: Any  # value, or callable(machine) -> value
    help: str = ""
    env_ok: bool = False  # overridable from environment (allow-list)


@dataclasses.dataclass(frozen=True)
class Machine:
    cpu_num: int
    memory_gb: int


def _bool(s: Any) -> bool:
    if isinstance(s, bool):
        return s
    s = str(s).strip().lower()
    if s in ("1", "true", "yes", "on"):
        return True
    if s in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"not a boolean: {s!r}")


def build_option_table() -> dict[str, Option]:
    """The full typed option table (ref: config.cpp:271-355)."""
    O = Option
    opts = [
        # ---- common (ref: config.cpp:271-290) -------------------------------
        O("temp_dir", str, "/tmp", "temp dir for fast access", env_ok=True),
        O("log_dir", str, "./log", "log dir", env_ok=True),
        O("ref_genome", str, "", "default reference genome path", env_ok=True),
        O("hosts", str, "", "host list for scale-out mode"),
        O("latency_mode", bool, False, "enable latency (scale-out) mode"),
        O("use_gatk4", bool, True,
          "GATK4-flavor semantics for callers/filters (reference defaults to "
          "GATK3; the TPU engine is GATK4-era by default)"),
        # ---- aligner (ref: config.cpp:293-309) ------------------------------
        O("bwa.verbose", int, 0, "verbose level of aligner logging"),
        O("bwa.nt", int, -1, "host threads for alignment IO (-1 = all)"),
        O("bwa.num_buckets", int, 1024, "coordinate buckets for aligned output"),
        O("bwa.enforce_order", bool, False, "enforce strict output ordering"),
        O("bwa.scaleout_mode", bool, None, "scale-out mode for alignment"),
        O("minimap.nt", int, -1, "host threads for minimap-class long-read path"),
        O("minimap.num_buckets", int, 2048, "buckets for long-read aligned output"),
        O("minimap.enforce_order", bool, False, "strict ordering for minimap path"),
        O("minimap.k", int, 19, "long-read minimizer k (map-ont neighborhood)"),
        O("minimap.w", int, 10, "long-read minimizer window"),
        O("tpu.batch.long_reads", int, 512, "long reads per device batch"),
        # ---- markdup / merge / sort (ref: config.cpp:311-318) ---------------
        O("markdup.max_files", int, 4096, "max open shard files in markdup"),
        O("markdup.nt", int, lambda m: min(16, m.cpu_num),
          "host threads in markdup"),
        O("markdup.overflow-list-size", int, 2000000, "overflow list size"),
        O("mergebam.max_files", int, 4096, "max open files in merge"),
        O("mergebam.nt", int, lambda m: min(16, m.cpu_num), "threads in merge"),
        O("sort.nprocs", int, lambda m: m.cpu_num, "parallel sort workers"),
        # ---- sharded caller stages (ref: config.cpp:320-352) ----------------
        O("gatk.intv.path", str, "", "path to existing contig interval shards"),
        O("gatk.ncontigs", int, 32, "genome partition count for caller stages"),
        O("gatk.nprocs", int, "auto_nprocs", "default worker count for caller stages"),
        O("gatk.memory", int, "auto_memory", "default per-worker memory budget (GB)"),
        O("gatk.nct", int, 1, "default intra-worker threads (deprecated)"),
        O("gatk.scaleout_mode", bool, None, "scale-out mode for caller stages"),
        O("gatk.skip_pseudo_chr", bool, True, "skip pseudo chromosomes (keep first 25)"),
        O("gatk.joint.ncontigs", int, 32, "partition count for joint genotyping"),
        O("gatk.rtc.nt", int, lambda m: min(16, m.cpu_num), "threads in RTC"),
        O("gatk.rtc.memory", int, lambda m: min(48, m.memory_gb), "memory in RTC"),
        O("gatk.combine.nprocs", int, "auto_nprocs", "workers in CombineGVCFs"),
        O("gatk.genotype.nprocs", int, "auto_nprocs", "workers in GenotypeGVCFs"),
        O("gatk.genotype.memory", int, "auto_memory", "memory in GenotypeGVCFs"),
        # ---- TPU engine (new; no reference analog) --------------------------
        O("tpu.mesh.data", int, -1, "data-parallel mesh axis size (-1 = all devices)"),
        O("tpu.mesh.region", int, 1, "region-parallel mesh axis size"),
        O("tpu.dist.num_processes", int, 0,
          "multi-host process count (0/1 = single process)", env_ok=True),
        O("tpu.dist.process_id", int, 0,
          "this process's rank in the multi-host job", env_ok=True),
        O("tpu.dist.coordinator", str, "",
          "coordinator address host:port (or file://<path>: process 0 "
          "binds a port and writes it there) for torch.distributed",
          env_ok=True),
        O("tpu.batch.reads", int, 4096, "reads per device batch"),
        O("tpu.align.spill_mb", int, 512,
          "FASTQ inputs above this spill aligned records to per-bucket "
          "temp files (bounded memory; the reference's temp-dir bucket "
          "tree, BWAWorker.cpp:134-147)"),
        O("tpu.bam.stream_mb", int, 64,
          "BAMs larger than this (compressed bytes) stream per-shard via "
          ".bai instead of loading whole; BGZF compresses BAM records "
          "~10-20x, so 64 MB compressed is already ~1 GB of columns"),
        O("tpu.bucket.read_len", int, 160, "read length bucket (pad-to)"),
        O("tpu.bucket.hap_len", int, 512, "haplotype length bucket (pad-to)"),
        O("tpu.pairhmm.dtype", str, "float32", "PairHMM accumulation dtype"),
        O("tpu.sw.band", int, 128, "Smith-Waterman extension band width"),
        O("tpu.profile", bool, False,
          "write a torch.profiler Chrome trace of each stage (every "
          "thread's host events, the card's, and the entries' spans)"),
    ]
    return {o.name: o for o in opts}


# per-stage fallback chains (ref: config.cpp:159-180): key -> parent key.
# Unset per-stage values resolve to the stage-global value.
FALLBACK_CHAINS: dict[str, str] = {}
for _stage in ("bqsr", "pr", "htc", "mutect2", "indel", "ug", "depth"):
    FALLBACK_CHAINS[f"gatk.{_stage}.nprocs"] = "gatk.nprocs"
    FALLBACK_CHAINS[f"gatk.{_stage}.memory"] = "gatk.memory"
for _stage in ("bqsr", "pr", "htc", "mutect2", "depth"):
    FALLBACK_CHAINS[f"gatk.{_stage}.nct"] = "gatk.nct"
FALLBACK_CHAINS["gatk.ug.nt"] = "gatk.nct"
FALLBACK_CHAINS["bwa.scaleout_mode"] = "latency_mode"
FALLBACK_CHAINS["gatk.scaleout_mode"] = "latency_mode"
del _stage


# ---------------------------------------------------------------------------
# Config object
# ---------------------------------------------------------------------------

class Config:
    """Layered configuration with first-set-wins priority.

    Priority (highest first): explicit ``set()`` / CLI ``-O key=value``,
    environment, local conf file, global conf file, built-in default
    (ref: init_config, config.cpp:118-153).
    """

    def __init__(self,
                 root_dir: str | None = None,
                 machine: Machine | None = None,
                 environ: dict[str, str] | None = None,
                 local_conf: str | None = None,
                 load_files: bool = True):
        self.machine = machine or Machine(get_sys_cpus(), get_sys_memory_gb())
        self.table = build_option_table()
        self._auto_nprocs, self._auto_memory = calc_default_worker_config(
            self.machine.cpu_num, self.machine.memory_gb)
        self._values: dict[str, Any] = {}          # resolved, layered
        self._explicit: dict[str, Any] = {}        # set() wins over all
        self.root_dir = root_dir or str(Path(sys.argv[0]).resolve().parent)
        environ = os.environ if environ is None else environ

        # layer 1: environment (allow-listed keys only, ref config.cpp:42-54)
        self._load_env(environ)
        if load_files:
            # layer 2: local conf file
            local = local_conf or CONF_BASENAME
            self._load_file(local)
            if not Path(local).exists():
                self._load_file(LEGACY_CONF_BASENAME)
            # layer 3: global conf file
            self._load_file(str(Path(self.root_dir) / CONF_BASENAME))
            self._load_file(str(Path(self.root_dir) / LEGACY_CONF_BASENAME))

        self.temp_dir = self._make_temp_dir()
        self.host_list = self._parse_hosts()

    # -- layering ------------------------------------------------------------

    def _store(self, key: str, raw: Any) -> None:
        """first-set-wins (like po::store): keep existing value."""
        if key in self._values:
            return
        if key not in self.table and key not in FALLBACK_CHAINS and \
                not key.startswith(("gatk.", "tpu.")):
            raise OptionsError(f"unknown option: {key}")
        self._values[key] = self._coerce(key, raw)

    def _coerce(self, key: str, raw: Any) -> Any:
        opt = self.table.get(key)
        typ = opt.type if opt else (
            self.table[FALLBACK_CHAINS[key]].type if key in FALLBACK_CHAINS else str)
        if typ is bool:
            return _bool(raw)
        if typ is int and not isinstance(raw, int):
            return int(str(raw).strip())
        if typ is str:
            return str(raw)
        return typ(raw)

    def _load_env(self, environ: dict[str, str]) -> None:
        # env-name mapper (ref config.cpp:42-54): FALCON_TEMP_DIR -> temp_dir,
        # only allow-listed options; dots become double underscores.
        allow = {o.name for o in self.table.values() if o.env_ok}
        for name, val in environ.items():
            for prefix in ENV_PREFIXES:
                if name.startswith(prefix):
                    key = name[len(prefix):].lower().replace("__", ".")
                    if key in allow:
                        self._store(key, val)
                    break

    def _load_file(self, path: str) -> None:
        p = Path(path)
        if not p.is_file():
            return
        section = ""
        for i, line in enumerate(p.read_text().splitlines(), 1):
            line = line.split("#", 1)[0].split(";", 1)[0].strip()
            if not line:
                continue
            m = re.fullmatch(r"\[(.+)\]", line)
            if m:  # INI-style sections become dotted prefixes
                section = m.group(1).strip() + "."
                continue
            if "=" not in line:
                raise OptionsError(f"{path}:{i}: expected key=value, got {line!r}")
            key, val = (s.strip() for s in line.split("=", 1))
            try:
                self._store(section + key, val)
            except OptionsError:
                log.warning("%s:%d: ignoring unknown option %r", path, i, section + key)
        log.debug("loaded config from %s", path)

    def _make_temp_dir(self) -> str:
        # <temp_dir>/falcon-genome-tpu-<user>-<pid> (ref config.cpp:182-194)
        user = os.environ.get("USER", "root")
        return f"{self.get('temp_dir')}/falcon-genome-tpu-{user}-{os.getpid()}"

    def _parse_hosts(self) -> list[str]:
        hosts = self.get("hosts") or ""
        return [h for h in re.split(r"[,\s]+", hosts) if h]

    # -- public API ----------------------------------------------------------

    def get(self, key: str, fallback_key: str | None = None) -> Any:
        """Resolve a key: explicit > layered > fallback chain > default.

        ``fallback_key`` mirrors ``get_config(arg, def_arg)``
        (config.h:48-56): if ``key`` has no value anywhere, resolve
        ``fallback_key`` instead.
        """
        if key in self._explicit:
            return self._explicit[key]
        if key in self._values:
            return self._values[key]
        chain = FALLBACK_CHAINS.get(key) or fallback_key
        if chain is not None and key not in self.table:
            return self.get(chain)
        opt = self.table.get(key)
        if opt is None:
            if chain is not None:
                return self.get(chain)
            raise OptionsError(f"unknown option: {key}")
        if key in FALLBACK_CHAINS and opt.default is None:
            return self.get(FALLBACK_CHAINS[key])
        return self._default_of(opt)

    def _default_of(self, opt: Option) -> Any:
        d = opt.default
        if d == "auto_nprocs":
            return self._auto_nprocs
        if d == "auto_memory":
            return self._auto_memory
        if callable(d):
            return self._coerce(opt.name, d(self.machine))
        return d

    def set(self, key: str, value: Any) -> None:
        self._explicit[key] = self._coerce(key, value)

    def has(self, key: str) -> bool:
        return key in self._explicit or key in self._values or key in self.table

    def check_resources(self, stage: str) -> list[str]:
        """Resource sanity warnings (ref: config.cpp:84-116). Returns warnings."""
        warnings = []
        nprocs = self.get(f"gatk.{stage}.nprocs")
        memory = self.get(f"gatk.{stage}.memory")
        if nprocs > self.machine.cpu_num:
            warnings.append(
                f"gatk.{stage}.nprocs ({nprocs}) exceeds cpu cores "
                f"({self.machine.cpu_num})")
        if memory < 4:
            warnings.append(
                f"gatk.{stage}.memory ({memory}) is too low; recommended ≥ 4 GB")
        elif nprocs * memory > self.machine.memory_gb * 1.05:
            warnings.append(
                f"gatk.{stage}.nprocs×memory ({nprocs}×{memory} GB) exceeds "
                f"system memory ({self.machine.memory_gb} GB)")
        for w in warnings:
            log.warning("%s", w)
        return warnings

    def dump(self) -> str:
        """Render all options with resolved values (the ``conf`` subcommand,
        ref config.cpp:362-366)."""
        lines = ["falcon-genome-tpu configuration options:"]
        for name in sorted(self.table):
            opt = self.table[name]
            lines.append(f"  {name:32s} = {self.get(name)!r:16} # {opt.help}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# global config (ref: config_vtable global + init(), config.cpp:23,239)
# ---------------------------------------------------------------------------

_global_config: Config | None = None


def init(root_dir: str | None = None, **kwargs) -> Config:
    global _global_config
    _global_config = Config(root_dir=root_dir, **kwargs)
    return _global_config


def get_config_obj() -> Config:
    global _global_config
    if _global_config is None:
        _global_config = Config()
    return _global_config


def get_config(key: str, fallback_key: str | None = None) -> Any:
    return get_config_obj().get(key, fallback_key)


def set_config(key: str, value: Any) -> None:
    get_config_obj().set(key, value)

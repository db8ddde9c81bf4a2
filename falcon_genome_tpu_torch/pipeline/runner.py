"""Stage-graph runner with barriers, timing, fail-fast, logs, and resume.

Semantics carried over from the reference's Executor (src/Executor.cpp):

* a *stage* is a set of tasks that run concurrently, followed by a barrier
  (Stage::run, Executor.cpp:50-72); stages run FIFO;
* every task gets a log file ``<log_dir>/<stage>-<ts>.log.<idx>``
  (Executor.cpp:284-312); on stage failure the logs are scraped with
  ``find_error`` for the de-duplicated operative diagnosis
  (LogUtils.cpp:10-40) and the pipeline aborts (``FailedCommand``,
  Executor.cpp:88-99);
* every stage logs "<name> finishes in N seconds" (Executor.cpp:51,101);
* resume: a stage whose declared outputs all exist is skipped unless
  ``force`` — deterministic artifact names make every stage re-runnable
  (the reference's checkpoint/resume story, SURVEY.md §5); a skipped
  stage returns its declared outputs so downstream gather steps still
  see the per-task artifact paths;
* ``profile_dir`` wraps each stage in a ``torch.profiler`` trace (the
  ``tpu.profile`` option) of every thread, written as a Chrome trace per
  stage; it holds the entries' spans (``utils/spans.py``).

Concurrency is a thread pool (tasks are IO + device-dispatch bound; the
GIL is released inside native code); ``nprocs`` mirrors
``gatk.<stage>.nprocs``.  Under several processes (``tpu.dist.*``) each
process owns a stage's tasks round-robin by index when every task has an
output, runs them under ``use_mesh(None)``, and after an end-of-stage
barrier adopts its peers' artifacts from the shared file system.

Port of ``falcon_genome_tpu/pipeline/runner.py``.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import logging
import re
import time
import traceback
from pathlib import Path
from typing import Callable

import torch

from ..utils.common import rss_suffix
from ..utils.errors import FailedCommand
from ..utils.logutils import find_error

from ..parallel.mesh import process_info, sync_processes, use_mesh

log = logging.getLogger("falcon_genome_tpu")


class StageError(FailedCommand):
    pass


@dataclasses.dataclass
class Task:
    fn: Callable[[], object]
    label: str = ""
    output: str | None = None   # per-task artifact → task-granular resume


@dataclasses.dataclass
class StageDef:
    name: str
    tasks: list[Task]
    outputs: list[str] = dataclasses.field(default_factory=list)
    nprocs: int = 1


def stage(name: str, tasks: list[Callable[[], object]] | list[Task],
          outputs: list[str] | None = None, nprocs: int = 1) -> StageDef:
    norm = [t if isinstance(t, Task) else Task(t, f"{name}[{i}]")
            for i, t in enumerate(tasks)]
    # declared outputs 1:1 with tasks → each task individually resumable
    # (a killed scatter restarts only its unfinished shards — the
    # reference persists per-contig artifacts the same way,
    # BQSRWorker.cpp:111-150)
    if outputs and len(outputs) == len(norm):
        for t, o in zip(norm, outputs):
            if t.output is None:
                t.output = o
    return StageDef(name, norm, outputs or [], nprocs)


class PipelineRunner:
    """Run stages in order; each stage is a parallel task set + barrier."""

    def __init__(self, name: str, force: bool = False,
                 log_dir: str | None = None,
                 profile_dir: str | None = None):
        self.name = name
        self.force = force
        self.log_dir = log_dir
        self.profile_dir = profile_dir
        self.timings: dict[str, float] = {}

    @classmethod
    def from_conf(cls, name: str, conf, force: bool = False
                  ) -> "PipelineRunner":
        profile_dir = None
        if conf.get("tpu.profile"):
            profile_dir = str(Path(conf.get("log_dir")) / "profile")
        return cls(name, force=force, log_dir=conf.get("log_dir"),
                   profile_dir=profile_dir)

    def _should_skip(self, s: StageDef) -> bool:
        if self.force or not s.outputs:
            return False
        return all(Path(o).exists() for o in s.outputs)

    def _task_log_path(self, s: StageDef, ts: int, idx: int) -> Path:
        safe = re.sub(r"[^\w.-]+", "_", f"{self.name}-{s.name}")
        return Path(self.log_dir) / f"{safe}-{ts}.log.{idx}"

    def run_stage(self, s: StageDef) -> list[object]:
        if self._should_skip(s):
            log.info("[%s] %s: outputs exist, skipping (resume)",
                     self.name, s.name)
            # hand the deterministic artifacts to downstream gather steps
            return (list(s.outputs)
                    if len(s.outputs) == len(s.tasks) else [])
        # multi-process scatter: each process owns tasks round-robin by
        # index and picks up its peers' artifacts from the shared file
        # system after the end-of-stage barrier (the reference's per-host
        # task dispatch, src/Executor.cpp:231-267).  Needs per-task outputs.
        pid, pcount = process_info()
        dist = (pcount > 1 and len(s.tasks) > 1
                and all(t.output is not None for t in s.tasks))
        t0 = time.time()
        ts = int(t0)
        n_local = sum(1 for i in range(len(s.tasks))
                      if not dist or i % pcount == pid)
        log.info("[%s] %s: %d task(s), %d worker(s)%s",
                 self.name, s.name, len(s.tasks), s.nprocs,
                 (f" ({n_local} local to process {pid}/{pcount})"
                  if dist else ""))
        log_paths: dict[int, Path] = {}
        if self.log_dir:
            Path(self.log_dir).mkdir(parents=True, exist_ok=True)

        n_resumed = 0
        peer = object()

        def run_task(i: int, t: Task):
            nonlocal n_resumed
            if dist and i % pcount != pid:
                return peer        # a peer process owns this task
            if (not self.force and t.output is not None
                    and Path(t.output).exists()):
                n_resumed += 1
                return t.output
            t_start = time.time()
            try:
                if dist:
                    # each process computes its own tasks on its own
                    # device (the mesh is thread-local: set per task)
                    with use_mesh(None):
                        out = t.fn()
                else:
                    out = t.fn()
            except Exception:
                tb = traceback.format_exc()
                if self.log_dir:
                    p = self._task_log_path(s, ts, i)
                    p.write_text(
                        f"task {t.label} failed after "
                        f"{time.time() - t_start:.1f}s\n{tb}\n")
                    log_paths[i] = p
                raise
            return out

        results: list[object] = [None] * len(s.tasks)
        errors: list[tuple[str, str]] = []
        if s.nprocs <= 1 or len(s.tasks) <= 1:
            for i, t in enumerate(s.tasks):
                try:
                    results[i] = run_task(i, t)
                except Exception:
                    errors.append((t.label, traceback.format_exc()))
                    break  # fail fast in serial mode
        else:
            with cf.ThreadPoolExecutor(max_workers=s.nprocs) as pool:
                futs = {pool.submit(run_task, i, t): i
                        for i, t in enumerate(s.tasks)}
                for fut in cf.as_completed(futs):
                    i = futs[fut]
                    try:
                        results[i] = fut.result()
                    except Exception:
                        errors.append((s.tasks[i].label,
                                       traceback.format_exc()))
        elapsed = time.time() - t0
        self.timings[s.name] = elapsed
        resumed = (f" ({n_resumed} task(s) resumed from existing outputs)"
                   if n_resumed else "")
        log.info("[%s] %s finishes in %d seconds%s%s", self.name, s.name,
                 int(elapsed), resumed, rss_suffix())
        if dist and not errors:
            # barrier, then adopt peers' artifacts from the shared FS
            sync_processes(f"{self.name}:{s.name}")
            for i, t in enumerate(s.tasks):
                if results[i] is peer:
                    if not Path(t.output).exists():
                        errors.append((t.label, f"peer artifact missing: "
                                                f"{t.output}"))
                    results[i] = t.output
            # and again: a stage's caller may merge and remove the
            # artifacts on the primary (indel) only once every process
            # has found them
            sync_processes(f"{self.name}:{s.name}:adopted")
        if errors:
            # operative diagnosis: scrape the per-task logs, de-duplicated
            # across shards (Executor.cpp:74-99 + LogUtils::findError)
            diag = find_error([str(p) for p in log_paths.values()])
            if not diag:
                uniq: list[str] = []
                for _, tb in errors:
                    last = tb.strip().splitlines()[-1]
                    if last not in uniq:
                        uniq.append(last)
                diag = " | ".join(uniq)
            where = (f" (task logs: {log_paths[min(log_paths)]} ...)"
                     if log_paths else "")
            raise StageError(
                f"stage '{s.name}' failed in {len(errors)}/{len(s.tasks)} "
                f"task(s): {diag}{where}")
        return results

    def _run_stage_profiled(self, s: StageDef) -> list[object]:
        if not self.profile_dir:
            return self.run_stage(s)
        import torch.profiler as tp
        Path(self.profile_dir).mkdir(parents=True, exist_ok=True)
        acts = [tp.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(tp.ProfilerActivity.CUDA)
        safe = re.sub(r"[^\w.-]+", "_", f"{self.name}-{s.name}")
        path = Path(self.profile_dir) / f"{safe}-{int(time.time())}.json"
        # every thread's host events: a stage's tasks run on a pool
        every_thread = tp._ExperimentalConfig(profile_all_threads=True)
        with tp.profile(activities=acts,
                        experimental_config=every_thread) as prof:
            out = self.run_stage(s)
        prof.export_chrome_trace(str(path))
        log.info("[%s] %s: profiler trace → %s", self.name, s.name, path)
        return out

    def run(self, stages: list[StageDef]) -> dict[str, list[object]]:
        out = {}
        t0 = time.time()
        for s in stages:
            out[s.name] = self._run_stage_profiled(s)
        log.info("[%s] pipeline finishes in %d seconds", self.name,
                 int(time.time() - t0))
        return out

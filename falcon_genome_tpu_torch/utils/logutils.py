"""Post-mortem failure diagnosis: scrape stage logs for the operative error.

Mirrors the reference's LogUtils::findError (src/LogUtils.cpp:10-40): scan
per-task logs for GATK-style ``##### ERROR`` blocks and htslib-style ``[E::``
lines, fall back to the last line, and de-duplicate the message that is common
across shards so the operator sees one diagnosis, not ncontigs copies.
"""
from __future__ import annotations

from pathlib import Path

_ERROR_MARKERS = ("##### ERROR", "[E::", "ERROR", "Traceback")


def _scrape_one(path: str) -> str:
    try:
        lines = Path(path).read_text(errors="replace").splitlines()
    except OSError:
        return ""
    lines = [ln for ln in lines if ln.strip()]
    hits = [ln for ln in lines if any(m in ln for m in _ERROR_MARKERS)]
    # a Python traceback's operative message is its LAST line (the
    # exception repr) — include it alongside the marker lines
    if lines and hits and lines[-1] not in hits:
        hits.append(lines[-1])
    if hits:
        return "\n".join(hits[-8:])
    return lines[-1] if lines else ""


def find_error(log_paths: list[str]) -> str:
    """Return a de-duplicated diagnosis across per-shard logs."""
    msgs = [m for m in (_scrape_one(p) for p in log_paths) if m]
    if not msgs:
        return ""
    uniq: list[str] = []
    for m in msgs:
        if m not in uniq:
            uniq.append(m)
    return "\n---\n".join(uniq)

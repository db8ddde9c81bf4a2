"""Stage-graph runner: barriers, timing, fail-fast, logs, resume."""

"""``--extra-options`` passthrough: the reference's per-tool flag
override mechanism (include/fcs-genome/Worker.h:38-58, behavior pinned by
test/bats/cases/extra-opts-check.bats).

Parsing semantics (exact):
* each ``--extra-options`` string splits on spaces;
* a token starting with ``-``/``--`` is a key; the following token is its
  value iff it does not itself start with ``-`` (else the key is boolean
  with an empty value);
* keys accumulate into a key → [values] multimap (repeat keys append);
* ``-nct`` is dropped (the reference manages GATK thread counts itself).

Application semantics: user-specified keys OVERRIDE the stage's defaults
(the reference builds the GATK command with the user's value and skips
its own default for that key).  The reference forwards unknown keys to
GATK verbatim; here known GATK option names map onto stage/model
parameters, and unknown keys are logged and recorded (``unused``) so
callers can surface them.
"""
from __future__ import annotations

import logging

log = logging.getLogger("falcon_genome_tpu")


def parse_extra_options(opts: list[str] | None) -> dict[str, list[str]]:
    """Worker.h:38-58 parse: space-split, dashed keys, optional values."""
    out: dict[str, list[str]] = {}
    for s in opts or []:
        toks = s.split(" ")
        i = 0
        while i < len(toks):
            t = toks[i]
            if t.startswith("-"):
                value = ""
                if i + 1 < len(toks) and not toks[i + 1].startswith("-"):
                    value = toks[i + 1]
                    i += 1
                if t != "-nct":
                    out.setdefault(t, []).append(value)
                    log.info("Parsing one extra option: Key=%s, Value=%s",
                             t, value)
            i += 1
    return out


class ExtraOpts:
    """Typed access over the parsed multimap with used-key tracking."""

    def __init__(self, opts: dict[str, list[str]] | list[str] | None):
        self.map = (opts if isinstance(opts, dict)
                    else parse_extra_options(opts))
        self._used: set[str] = set()

    def __bool__(self) -> bool:
        return bool(self.map)

    def get(self, *keys: str, default: str | None = None) -> str | None:
        """Last value among any alias of the option (override-wins)."""
        val = default
        for k in keys:
            if k in self.map and self.map[k]:
                val = self.map[k][-1]
                self._used.add(k)
        return val

    def get_all(self, *keys: str) -> list[str]:
        out: list[str] = []
        for k in keys:
            if k in self.map:
                out.extend(v for v in self.map[k] if v)
                self._used.add(k)
        return out

    def get_float(self, *keys: str, default: float | None = None):
        v = self.get(*keys)
        return default if v is None or v == "" else float(v)

    def get_int(self, *keys: str, default: int | None = None):
        v = self.get(*keys)
        return default if v is None or v == "" else int(v)

    def has(self, *keys: str) -> bool:
        hit = False
        for k in keys:
            if k in self.map:
                self._used.add(k)
                hit = True
        return hit

    def warn_unused(self, stage: str) -> list[str]:
        unused = sorted(set(self.map) - self._used)
        for k in unused:
            log.warning("%s: extra option %s has no effect in the TPU "
                        "engine (accepted for reference compatibility)",
                        stage, k)
        return unused

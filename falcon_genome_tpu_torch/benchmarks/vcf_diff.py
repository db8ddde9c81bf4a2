"""Two VCFs compared field by field: how many records are equal in every
field, and the first that are not.

A record is keyed by (CHROM, POS, REF, ALT); its fields are CHROM, POS,
ID, REF, ALT, QUAL, FILTER, INFO's entries in order, FORMAT and each
sample's FORMAT values by key.  ``utils.compare.compare_vcf`` compares
the key and the GT; this compares everything a user reads (PL, GQ, AD,
QUAL among it), so a likelihood that is one bit off at a near-tie
shows.  ``--site CHROM:POS`` reports the records at a position on both
sides.  One JSON line goes to stdout (and, with ``--out``, is appended
to that file); the exit code is 0 when every record is equal.

Usage:
    python -m falcon_genome_tpu_torch.benchmarks.vcf_diff A.vcf[.gz]
        B.vcf[.gz] [--site CHROM:POS ...] [--show N] [--out PATH]
"""
from __future__ import annotations

import argparse
import gzip
import json
import sys
from pathlib import Path

# differing records printed in full
SHOW = 5


def vcf_records(path) -> list[tuple]:
    """Every data line of a VCF as a tuple of its fields: CHROM, POS, ID,
    REF, ALT, QUAL, FILTER, INFO's entries in order, FORMAT, and each
    sample's FORMAT values by key."""
    opener = gzip.open if str(path).endswith(".gz") else open
    out = []
    with opener(path, "rt") as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            col = line.rstrip("\n").split("\t")
            info = tuple(col[7].split(";")) if len(col) > 7 else ()
            fmt = col[8].split(":") if len(col) > 8 else []
            samples = tuple(tuple(zip(fmt, s.split(":"))) for s in col[9:])
            out.append((col[0], int(col[1]), col[2], col[3], col[4],
                        col[5], col[6], info, tuple(fmt), samples))
    return out


def _key(rec: tuple) -> tuple:
    return rec[0], rec[1], rec[3], rec[4]


def _line(rec: tuple) -> str:
    info = ";".join(rec[7])
    samples = [":".join(v for _, v in s) for s in rec[9]]
    return "\t".join([rec[0], str(rec[1]), rec[2], rec[3], rec[4], rec[5],
                      rec[6], info, ":".join(rec[8]), *samples])


def diff(a_path, b_path, sites=(), show: int = SHOW) -> dict:
    """The comparison as a dict (see the module docstring)."""
    a, b = vcf_records(a_path), vcf_records(b_path)
    by_a = {_key(r): r for r in a}
    by_b = {_key(r): r for r in b}
    both = [k for k in by_a if k in by_b]
    differ = [k for k in both if by_a[k] != by_b[k]]
    out = {"a": str(a_path), "b": str(b_path), "records_a": len(a),
           "records_b": len(b), "keys_in_both": len(both),
           "only_a": len(by_a) - len(both), "only_b": len(by_b) - len(both),
           "equal_in_every_field": len(both) - len(differ),
           "differ": len(differ),
           "first_differing": [{"a": _line(by_a[k]), "b": _line(by_b[k])}
                               for k in differ[:show]]}
    out["all_equal"] = (out["equal_in_every_field"] == len(a) == len(b))
    for site in sites:
        chrom, pos = site.rsplit(":", 1)
        pos = int(pos.replace(",", ""))
        out.setdefault("sites", {})[site] = {
            side: [_line(r) for r in recs if r[0] == chrom and r[1] == pos]
            for side, recs in (("a", a), ("b", b))}
        s = out["sites"][site]
        s["equal"] = bool(s["a"]) and s["a"] == s["b"]
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--site", action="append", default=[],
                    metavar="CHROM:POS")
    ap.add_argument("--show", type=int, default=SHOW)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = diff(args.a, args.b, args.site, args.show)
    line = json.dumps(res)
    print(line)
    if args.out:
        with Path(args.out).open("a") as f:
            f.write(line + "\n")
    return 0 if res["all_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())

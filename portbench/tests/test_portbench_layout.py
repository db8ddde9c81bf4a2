"""BENCHMARK.json and the files its names lead to."""
import ast
import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_files_resolve(w):
    assert NAME.match(w["name"]) and NAME.match(w["config"]) \
        and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    cfg = {c["name"]: c for c in SPEC["configs"]}[w["config"]]
    assert (ROOT / cfg["file"]).is_file()
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    assert (BENCH / "gen" / f"{traffic['generator']}.py").is_file()
    names = {m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]
             if "workloads" not in m or w["name"] in m["workloads"]}
    assert "setup_s" in names and traffic["throughput_metric"] in names


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_matches(c):
    assert NAME.match(c["name"]) and len(c["source"]) <= 200
    assert all(NAME.match(k) for k in c["reduced"])
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]
    assert any(w["config"] == c["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("m", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_names_and_units(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if m in SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    else:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_imports(path):
    banned = {"jax", "jaxlib", "flax", "falcon_genome_tpu"}
    found = [m for m in _imports(path) if m.split(".")[0] in banned]
    assert not found, found


def test_forbidden_modules_by_whole_name():
    import harness
    assert harness.forbidden_modules(["falcon_genome_tpu_torch.ops",
                                      "numpy", "jaxtyping"]) == []
    assert harness.forbidden_modules(["jax.numpy", "falcon_genome_tpu.ops"]
                                     ) == ["falcon_genome_tpu.ops",
                                           "jax.numpy"]

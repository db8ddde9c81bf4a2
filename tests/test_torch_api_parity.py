"""The port's completeness against the JAX package, checked from source.

Both packages are parsed with ``ast`` (nothing is imported, so neither
JAX nor the reference package is needed).  For every module of
``falcon_genome_tpu/`` the reference's names are its top-level functions
and classes, each class's methods and class-level attributes, and its
UPPERCASE module constants (``_``-prefixed ones included).  Every such
name must exist in the port's module at the same relative path, unless
:data:`EXCLUDED` lists it with its reason.  The table is the whole record
of what the port leaves out, and it cannot rot: every name in it must
still exist in the reference and still be absent from the port.

The root ``benchmarks/*.py`` scripts are held the same way: each maps to
``falcon_genome_tpu_torch/benchmarks/`` with its top-level names, or
stands in :data:`SCRIPTS` with its reason.  A new root script, or a
row whose script the port has since matched name for name, fails.

Run alone: ``python -m pytest tests/test_torch_api_parity.py``.
"""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
REF = REPO / "falcon_genome_tpu"
PORT = REPO / "falcon_genome_tpu_torch"
REF_SCRIPTS = REPO / "benchmarks"
PORT_SCRIPTS = PORT / "benchmarks"

# The two reasons a reference name may have no counterpart in the port.
TPU_ONLY = ("TPU-only: Pallas kernels and their JAX/Pallas dispatch, "
            "jit and compile caches, TPU backend and lane choices, and "
            "interpret-mode host paths; the ground rules say not to carry "
            "them over, and the port's CUDA kernels and their plain "
            "versions take their place")
DEAD = ("dead code: nothing in the reference, its tests, bench.py or "
        "benchmarks/ calls or reads it")

_SW_TPU = (
    # Pallas kernels (K1, K2) and the device traceback JAX code (K3 is
    # fgt_sw_traceback, with its own plain version)
    "_sw_kernel", "_sw_score_kernel", "_traceback_device",
    # Pallas / JAX dispatchers and their window gathers
    "_sw_jax", "_sw_device", "_sw_device_fused", "_sw_pallas_full",
    "_sw_pallas_score", "_sw_gather_full", "_sw_gather_score",
    "_sw_winget_full",
    # lane layout and packing of the Pallas calls
    "LANES", "_shift_down", "_pow2_lanes", "_transpose_dev", "_pack_meta",
    "_META_READ_IDX", "_META_IS_REV", "_META_RLEN", "_META_START",
    "_META_WLEN", "_decode_traceback", "SWBucket.backend",
    # the interpret-mode host traceback (smith_waterman.py:1249-1270)
    "traceback",
)
_PAIRHMM_TPU = (
    # Pallas kernels (K5, K4)
    "_pairhmm_kernel", "_pairhmm_kernel_sc",
    # Pallas / JAX dispatchers, their jit wrappers and sharded caches
    "_pairhmm_jax", "_pairhmm_device", "_pairhmm_device_sc",
    "_pairhmm_device_sc_jit", "_pairhmm_fused", "_pairhmm_pairs_fused",
    "_pairhmm_sharded", "_pairhmm_sharded_fused", "_SHARDED_CACHE",
    # lane layout, bucket costing and unpacking of the Pallas calls
    "LANES", "_round_up", "_shift_down", "_bucket_cost", "_local_pairhmm",
    "_pairhmm_unpack",
    # backend choice (the port's parameters carry a torch.device)
    "PairHMMParams.backend", "PairHMMParams.lanes",
    "PairHMMParams.interpret",
)

# (module path relative to the package, name) -> reason
EXCLUDED: dict[tuple[str, str], str] = {
    ("__init__.py", "_enable_compile_cache"): TPU_ONLY,
    **{("ops/smith_waterman.py", n): TPU_ONLY for n in _SW_TPU},
    **{("ops/pairhmm.py", n): TPU_ONLY for n in _PAIRHMM_TPU},
    # interpret-mode host traceback, reached only from the Pallas path
    ("io/native_ext.py", "sw_traceback_batch"): TPU_ONLY,
    # the jit-compile cache of one sort step; the port's
    # distributed_sort is eager, and SORT_PAD stands for SORT_SENTINEL
    ("parallel/sharded.py", "distributed_sort_step"): TPU_ONLY,
    ("parallel/sharded.py", "_default_params"): TPU_ONLY,
    ("parallel/sharded.py", "_SORT_STEP_CACHE"): TPU_ONLY,
    ("parallel/sharded.py", "SORT_SENTINEL"): TPU_ONLY,
    # chooses between the Pallas and the JAX backend
    ("aligner.py", "AlignerEngine._bucket"): TPU_ONLY,
    ("aligner.py", "AlignerEngine._extend"): DEAD,
    ("models/assembly.py", "_kmer_strs"): DEAD,
    ("longread.py", "_assemble"): DEAD,
    ("stages/indel.py", "_lead_clip"): DEAD,
    # a PairHMM parameter override that no reference code reads
    ("models/haplotypecaller.py", "HTCParams.pairhmm"): DEAD,
    # stage timers that nothing calls; the port's runner logs its stage
    # walls and its entries record spans (utils/spans.py)
    ("utils/common.py", "now_ts"): DEAD,
    ("utils/common.py", "log_time"): DEAD,
    ("utils/common.py", "Timer"): DEAD,
    ("utils/common.py", "Timer.__init__"): DEAD,
    ("utils/common.py", "Timer.__enter__"): DEAD,
    ("utils/common.py", "Timer.__exit__"): DEAD,
}


# Root benchmark scripts that do not map name for name, with the reason.
PORTED_EARLIER = ("ported with the kernels, as the timing of K7 (the "
                  "port's CUDA ablation kernel): the Pallas kernel factory "
                  "make_kernel and its LANES are TPU-only")
SCRIPTS: dict[str, str] = {
    "ablate_sw.py": PORTED_EARLIER,
}


def _targets(node) -> list[ast.expr]:
    return node.targets if isinstance(node, ast.Assign) else [node.target]


def _is_constant(name: str) -> bool:
    core = name.lstrip("_")
    return bool(core) and core.isupper()


def public_names(source: str) -> set[str]:
    """Top-level defs and classes, ``Class.member`` for each method and
    class-level attribute, and UPPERCASE module constants."""
    out: set[str] = set()
    for node in ast.parse(source).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out.add(f"{node.name}.{m.name}")
                elif isinstance(m, (ast.Assign, ast.AnnAssign)):
                    out.update(f"{node.name}.{t.id}" for t in _targets(m)
                               if isinstance(t, ast.Name))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in _targets(node):
                out.update(n.id for n in ast.walk(t)
                           if isinstance(n, ast.Name) and _is_constant(n.id))
    return out


def module_names(root: Path) -> dict[str, set[str]]:
    """Names of every module under ``root``, by relative path."""
    return {str(p.relative_to(root)): public_names(p.read_text())
            for p in sorted(root.rglob("*.py"))}


def unported(ref: dict[str, set[str]], port: dict[str, set[str]],
             excluded) -> dict[str, list[str]]:
    """Reference names with no counterpart in the port's module at the
    same path and no row in ``excluded``, by module."""
    out = {}
    for rel, names in ref.items():
        miss = sorted(n for n in names - port.get(rel, set())
                      if (rel, n) not in excluded)
        if miss:
            out[rel] = miss
    return out


REF_NAMES = module_names(REF)
PORT_NAMES = module_names(PORT)
REF_SCRIPT_NAMES = {p.name: public_names(p.read_text())
                    for p in sorted(REF_SCRIPTS.glob("*.py"))}
PORT_SCRIPT_NAMES = {p.name: public_names(p.read_text())
                     for p in sorted(PORT_SCRIPTS.glob("*.py"))}


@pytest.mark.parametrize("rel", sorted(REF_NAMES))
def test_reference_module_ported(rel):
    """Every name of the reference module is in the port's module at the
    same path, or excluded with its reason."""
    assert rel in PORT_NAMES, f"the port has no {rel}"
    assert unported({rel: REF_NAMES[rel]}, PORT_NAMES, EXCLUDED) == {}


def test_exclusions_still_name_reference_code():
    """Each excluded name still exists in the reference and is still
    absent from the port, and each row gives one of the two reasons."""
    for (rel, name), reason in EXCLUDED.items():
        assert name in REF_NAMES.get(rel, set()), (rel, name)
        assert name not in PORT_NAMES.get(rel, set()), (rel, name)
        assert reason in (TPU_ONLY, DEAD), (rel, name)


@pytest.mark.parametrize("script", sorted(REF_SCRIPT_NAMES.keys() - SCRIPTS))
def test_benchmark_script_ported(script):
    """Every root benchmark script without a row in SCRIPTS has a port
    with all its names."""
    assert script in PORT_SCRIPT_NAMES, f"the port has no benchmarks/{script}"
    assert unported({script: REF_SCRIPT_NAMES[script]}, PORT_SCRIPT_NAMES,
                    {}) == {}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_benchmark_script_table(script):
    """Each row names a root script that the port has, ported earlier,
    and that still lacks some of the root script's names (else it
    belongs with the mapped scripts)."""
    assert script in REF_SCRIPT_NAMES
    assert SCRIPTS[script] == PORTED_EARLIER
    assert script in PORT_SCRIPT_NAMES
    assert unported({script: REF_SCRIPT_NAMES[script]},
                    PORT_SCRIPT_NAMES, {})


def test_comparison_fails_for_an_unported_name(tmp_path):
    """On two small synthetic packages the comparison reports a reference
    function, method and constant the port lacks, and nothing once the
    missing names are ported or excluded."""
    ref, port = tmp_path / "ref", tmp_path / "port"
    for d in (ref / "io", port / "io"):
        d.mkdir(parents=True)
    (ref / "a.py").write_text(
        "import os\nLIMIT = 3\n_CACHE: dict = {}\nlower = 1\n\n"
        "def f(x):\n    def inner():\n        pass\n    return x\n\n"
        "class K:\n    size: int = 1\n\n    def m(self):\n        pass\n\n"
        "    @property\n    def p(self):\n        return 1\n")
    (ref / "io" / "b.py").write_text("def g():\n    pass\n")
    (port / "a.py").write_text(
        "LIMIT = 4\n\ndef f(x):\n    return x\n\n"
        "class K:\n    size: int = 2\n\n    def m(self):\n        pass\n")
    want = {"a.py": ["K.p", "_CACHE"], "io/b.py": ["g"]}
    assert public_names((ref / "a.py").read_text()) == {
        "LIMIT", "_CACHE", "f", "K", "K.size", "K.m", "K.p"}
    got = unported(module_names(ref), module_names(port), {})
    assert got == want
    (port / "io" / "b.py").write_text("def g():\n    return 1\n")
    got = unported(module_names(ref), module_names(port),
                   {("a.py", "K.p"): DEAD})
    assert got == {"a.py": ["_CACHE"]}
    got = unported(module_names(ref), module_names(port),
                   {("a.py", "K.p"): DEAD, ("a.py", "_CACHE"): TPU_ONLY})
    assert got == {}

"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` for Hopper (``sm_90a``), one ``nvcc``
per source, all started together, and link into one shared library with a
plain C interface, loaded with ``ctypes``.  The build runs
at first use and is keyed on a hash of the sources and flags, so a fresh
checkout builds everything on its first kernel launch and a stale library
is never loaded.  Output goes to ``build/torch_kernels/`` at the repository
root (listed in ``.gitignore``), together with the compiler's register and
spill report (``ptxas -v``).

There is no fallback: a missing ``nvcc`` or a failed build raises
:class:`KernelBuildError`.  Only wrappers handed CUDA tensors call
:func:`load`; CPU tensors never reach it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / \
    "torch_kernels"
SOURCES = ("smith_waterman.cu", "pairhmm.cu", "bench_kernels.cu")
TOOLKIT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags of one source only: PairHMM flushes every float32 result and
# contracts no multiply-add the plain version does not fuse; the FMA
# ceiling (bench_kernels.cu) keeps nvcc's defaults
SOURCE_FLAGS = {"pairhmm.cu": ("-ftz=true", "--fmad=false")}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: every pointer and the stream as c_void_p; each returns
# cudaGetLastError() after its launch
SIGNATURES = {
    # read, win, rlen, wlen, B, R, W, match, mismatch, go, ge,
    # score_out, pos_out, stream
    "fgt_sw_score": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                     _P),
    # ... as fgt_sw_score, plus the (B, stripes, words, 32 NR) pointers
    "fgt_sw_full": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                    _P, _P),
    # ptr, best, pos, B, NR, stripes, words, max_steps, packed_out,
    # coords_out, stream
    "fgt_sw_traceback": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
    # read, base_q, table, rlen, hap, hlen, B, R, H, p_ins, p_del, p_cont,
    # a_mm, a_im, logp_out, queue, stream
    "fgt_pairhmm": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F,
                    _P, _P, _P),
    # read, base_q, ins_q, del_q, gcp, table, rlen, hap, hlen, B, R, H,
    # logp_out, queue, stream
    "fgt_pairhmm_pb": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P,
                       _P, _P),
    # x, R, B, trips, a, b, zero, out, stream
    "fgt_fma_ceiling": (_P, _I, _I, _I, _F, _F, _F, _P, _P),
    # read, win, rlen, wlen, B, R, W, match, mismatch, go, ge, flags,
    # score_out, pos_out, stream
    "fgt_sw_score_ablate": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                            _P, _P, _P),
}


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be built or loaded."""


_lib: ctypes.CDLL | None = None
_lock = threading.Lock()

# the process's load of the library: 1 once it is loaded, its wall
# seconds (build, dlopen, bind), and the nvcc builds run (0 when the
# library of this digest was there)
LOAD = {"loads": 0, "seconds": 0.0, "builds": 0}


def find_nvcc() -> str:
    """Path of ``nvcc``: PATH, then ``$CUDA_HOME/bin``, then the default
    toolkit location; raises when none exists."""
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append(TOOLKIT_NVCC)
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libfgt_kernels-{_digest()}.so"


def build() -> Path:
    """Compile the sources unless a library of this digest exists: one
    ``nvcc -c`` per source in parallel, then one link."""
    so = library_path()
    if so.exists():
        return so
    nvcc = find_nvcc()
    LOAD["builds"] += 1
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [so.with_name(f"{so.stem}-{Path(s).stem}.{tag}.o")
            for s in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(s, ()), "-c", "-o",
             str(o), str(CSRC / s)]
            for s, o in zip(SOURCES, objs)]
    tmp = so.with_name(f"{so.name}.{tag}")
    cmds.append([nvcc, "-shared", "-o", str(tmp), *map(str, objs)])
    try:
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for c in cmds[:-1]]
        results = []
        for c, p in zip(cmds, procs):
            out, err = p.communicate()
            results.append((c, p.returncode, out, err))
        if all(rc == 0 for _, rc, _, _ in results):
            res = subprocess.run(cmds[-1], capture_output=True, text=True)
            results.append((cmds[-1], res.returncode, res.stdout,
                            res.stderr))
        report = BUILD_DIR / f"{so.stem}.ptxas.txt"
        report.write_text("".join(out + err for _, _, out, err in results))
        for cmd, rc, _, err in results:
            if rc != 0:
                raise KernelBuildError(
                    f"nvcc failed ({rc}): {' '.join(cmd)}\n{err[-4000:]}")
        os.replace(tmp, so)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return so


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            so = build()
            try:
                lib = ctypes.CDLL(str(so))
            except OSError as e:
                raise KernelBuildError(f"cannot load {so}: {e}") from e
            _lib = bind(lib)
            LOAD["loads"] += 1
            LOAD["seconds"] = time.perf_counter() - t0
        return _lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Give the C entry points of ``lib`` that it has their signatures."""
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")

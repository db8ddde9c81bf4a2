"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs
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
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / \
    "torch_kernels"
SOURCES = ("smith_waterman.cu", "pairhmm.cu")
TOOLKIT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    # ... as fgt_sw_score, plus the (B, R+W, R) pointer array
    "fgt_sw_full": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                    _P, _P),
    # ptr, best, pos, B, R, W, max_steps, packed_out, coords_out, stream
    "fgt_sw_traceback": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    # read, p_err, rlen, hap, hlen, B, R, H, p_ins, p_del, p_cont, a_mm,
    # a_im, acc_out, shift_out, stream
    "fgt_pairhmm": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F,
                    _P, _P, _P),
}


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be built or loaded."""


_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


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
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libfgt_kernels-{_digest()}.so"


def build() -> Path:
    """Compile the sources unless a library of this digest exists."""
    so = library_path()
    if so.exists():
        return so
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    report = BUILD_DIR / f"{so.stem}.ptxas.txt"
    report.write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
            f"{res.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            so = build()
            try:
                lib = ctypes.CDLL(str(so))
            except OSError as e:
                raise KernelBuildError(f"cannot load {so}: {e}") from e
            for name, args in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")

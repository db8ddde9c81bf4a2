"""DNA base encoding shared by every codec and kernel.

Bases are encoded as small uint8 codes (A=0, C=1, G=2, T=3, N/other=4) — the
same 4-bit-free layout the DP kernels consume, so sequence arrays go from
file bytes to device HBM without re-mapping.  Ambiguity codes (IUPAC) map to N.
"""
from __future__ import annotations

import numpy as np

BASE_A, BASE_C, BASE_G, BASE_T, BASE_N = 0, 1, 2, 3, 4
N_BASES = 4  # cardinality of the unambiguous alphabet

_ENCODE_LUT = np.full(256, BASE_N, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _ENCODE_LUT[_b] = _i
    _ENCODE_LUT[ord(chr(_b).lower())] = _i

_DECODE_LUT = np.frombuffer(b"ACGTN", dtype=np.uint8)

# complement in code space: A<->T, C<->G, N->N
_COMP_LUT = np.array([BASE_T, BASE_G, BASE_C, BASE_A, BASE_N], dtype=np.uint8)


def encode_seq(seq: str | bytes) -> np.ndarray:
    """ASCII sequence → uint8 code array."""
    if isinstance(seq, str):
        seq = seq.encode()
    return _ENCODE_LUT[np.frombuffer(seq, dtype=np.uint8)]


def encode_seq_np(ascii_arr: np.ndarray) -> np.ndarray:
    """uint8 ASCII array → uint8 code array (vectorized)."""
    return _ENCODE_LUT[ascii_arr]


def decode_seq(codes: np.ndarray) -> str:
    return _DECODE_LUT[np.asarray(codes, dtype=np.uint8)].tobytes().decode()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement in code space."""
    return _COMP_LUT[codes[::-1]]

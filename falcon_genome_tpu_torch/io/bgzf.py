"""BGZF (blocked gzip) codec — the container under BAM and ``.vcf.gz``.

Replaces the reference's shelled-out ``bgzip`` (src/workers/VCFUtilsWorker.cpp
ZIPWorker) with an in-repo codec.  A BGZF file is a series of gzip members,
each ≤ 64 KiB, carrying a BSIZE ("BC") extra subfield so readers can seek by
virtual offset; the file ends with a fixed 28-byte EOF member.

A C++ twin of the deflate hot loop lives in ``native/fgio.cpp``
(zlib-backed); this module uses it when built, else pure Python zlib.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

MAX_BLOCK = 65280  # uncompressed payload per block (matches htslib)

_EOF_BLOCK = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def _block(payload: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    data = co.compress(payload) + co.flush()
    bsize = len(data) + 25 + 1  # header(12) + xlen(6) + data + crc(4)+isize(4)
    header = struct.pack(
        "<BBBBIBBHBBHH",
        0x1f, 0x8b, 8, 4,   # gzip magic, deflate, FEXTRA
        0, 0, 0xff,         # mtime, xfl, os
        6,                  # xlen
        0x42, 0x43, 2,      # 'B' 'C', subfield len
        bsize - 1)
    return header + data + struct.pack("<II", zlib.crc32(payload),
                                       len(payload) & 0xffffffff)


class BgzfWriter:
    def __init__(self, path: str | Path, level: int = 6):
        self._f = open(path, "wb")
        self._buf = bytearray()
        self.level = level
        self._coffset = 0  # compressed bytes written so far

    @property
    def virtual_offset(self) -> int:
        """BGZF virtual offset (coffset << 16 | within-block offset) of the
        next byte to be written — the coordinate space of .tbi/.bai."""
        return (self._coffset << 16) | len(self._buf)

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= MAX_BLOCK:
            self._flush_block(self._buf[:MAX_BLOCK])
            del self._buf[:MAX_BLOCK]

    def _flush_block(self, payload) -> None:
        from . import native_ext
        data = native_ext.bgzf_compress(bytes(payload), self.level)
        if data is None:
            data = _block(bytes(payload), self.level)
        self._f.write(data)
        self._coffset += len(data)

    def flush(self) -> None:
        if self._buf:
            self._flush_block(self._buf)
            self._buf.clear()

    def close(self) -> None:
        if self._f.closed:
            return
        self.flush()
        self._f.write(_EOF_BLOCK)
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BgzfReader:
    """Streaming reader over concatenated gzip members."""

    def __init__(self, path: str | Path):
        self._f = open(path, "rb")
        self._decomp = None
        self._buf = bytearray()
        self._eof = False

    def _fill(self) -> bool:
        # decompress one member's worth of data into _buf
        chunk = self._f.read(65536)
        if not chunk:
            self._eof = True
            return False
        if self._decomp is None:
            self._decomp = zlib.decompressobj(31)
        self._buf += self._decomp.decompress(chunk)
        while self._decomp.eof:
            rest = self._decomp.unused_data
            self._decomp = zlib.decompressobj(31)
            if rest:
                self._buf += self._decomp.decompress(rest)
            else:
                break
        return True

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            while self._fill():
                pass
            out = bytes(self._buf)
            self._buf.clear()
            return out
        while len(self._buf) < n and not self._eof:
            self._fill()
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

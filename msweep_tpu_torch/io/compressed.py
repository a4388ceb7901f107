"""Transparent compressed-file I/O.

Replaces the reference's bxzstr/cxxio stack (L0/L1 in SURVEY.md section 1):
input files are sniffed by magic bytes (gzip / bzip2 / xz / zstd) like
``bxz::ifstream`` does, and outputs can be compressed with the algorithms
accepted by the reference's ``--compress`` flag
(src/OutfileDesignator.cpp:44-62): z(.gz), bz2(.bz2), lzma(.xz), zstd(.zst).
"""

from __future__ import annotations

import bz2
import gzip
import lzma
import os
import sys
from typing import BinaryIO

_MAGIC = [
    (b"\x1f\x8b", "z"),
    (b"BZh", "bz2"),
    (b"\xfd7zXZ\x00", "lzma"),
    (b"\x28\xb5\x2f\xfd", "zstd"),
]

# zstd is optional in the reference too (bxzstr built without zstd unless
# found); gate on the stdlib/3rd-party module being importable.
try:  # pragma: no cover - environment dependent
    from compression import zstd as _zstd  # python>=3.14 stdlib
except ImportError:
    try:
        import zstandard as _zstd_mod  # type: ignore

        class _zstd:  # noqa: N801 - adapter
            @staticmethod
            def open(path, mode="rb", level=None):
                if "r" in mode:
                    return _zstd_mod.open(path, mode)
                cctx = _zstd_mod.ZstdCompressor(level=level if level else 3)
                return _zstd_mod.open(path, mode, cctx=cctx)

    except ImportError:
        _zstd = None


def sniff_compression(path: str) -> str:
    """Return one of plaintext/z/bz2/lzma/zstd by reading magic bytes."""
    with open(path, "rb") as f:
        head = f.read(6)
    for magic, name in _MAGIC:
        if head.startswith(magic):
            return name
    return "plaintext"


def open_input(path: str) -> BinaryIO:
    """Open a possibly-compressed file for binary reading (auto-detect)."""
    kind = sniff_compression(path)
    if kind == "z":
        return gzip.open(path, "rb")
    if kind == "bz2":
        return bz2.open(path, "rb")
    if kind == "lzma":
        return lzma.open(path, "rb")
    if kind == "zstd":
        if _zstd is None:
            raise RuntimeError("zstd-compressed input but no zstd module available")
        return _zstd.open(path, "rb")
    return open(path, "rb")


def read_input_bytes(path: str | None) -> bytes:
    """Read a whole possibly-compressed file (or stdin when path is None)."""
    if path is None:
        return sys.stdin.buffer.read()
    with open_input(path) as f:
        return f.read()


EXTENSIONS = {"z": ".gz", "bz2": ".bz2", "lzma": ".xz", "zstd": ".zst"}


def open_output(path: str, compress: str = "plaintext", level: int = 6):
    """Open a text output stream, optionally compressed.

    Mirrors OutfileDesignator::open (src/OutfileDesignator.cpp:30-37):
    the extension for the chosen algorithm is appended to `path`.
    Returns (stream, final_path).
    """
    if compress == "plaintext":
        return open(path, "w"), path
    final = path + EXTENSIONS[compress]
    if compress == "z":
        return gzip.open(final, "wt", compresslevel=level), final
    if compress == "bz2":
        return bz2.open(final, "wt", compresslevel=level), final
    if compress == "lzma":
        preset = min(max(level, 0), 9)
        return lzma.open(final, "wt", preset=preset), final
    if compress == "zstd":
        if _zstd is None:
            raise RuntimeError("zstd output requested but no zstd module available")
        return _zstd.open(final, "wt", level=level), final
    raise ValueError(f"unsupported compression type {compress}")

"""Packed pseudoalignment codec (alignment-writer replacement).

The reference consumes alignments packed by the external
`alignment-writer` library (the reference's `include/mSWEEP_alignment.hpp:103-114`,
produced per the reference's `docs/example.md:36-40`):

    n_reads,n_refs\n            <- alignment_writer::ReadHeader contract
    <chunk_bytes>\n             <- ASCII byte count of the next chunk
    <chunk: serialized BitMagic bvector, io/bitmagic.py>
    ... repeated until EOF; chunks are OR-merged (UnpackData semantics)

Bits are ``read*n_refs + target`` (the reference's indexing).  The chunk
framing is reconstructed from alignment-writer v0.5.0's Pack/UnpackData
loop (size line via getline + stoul, then a raw buffer passed to
``bm::deserialize``); the BitMagic block wire format itself is implemented
in io/bitmagic.py with per-opcode confidence notes.

``pack_pairs`` emits this format with conservative BitMagic opcodes, so
files packed by msweep-tpu are readable by genuine BitMagic builds.
Files produced by msweep-tpu round 1 used a private zlib format behind a
``#msweep-tpu-pack`` meta line; those remain readable (legacy path).

`msweep-tpu pack|unpack` (cli_pack.py) mirrors the standalone
alignment-writer binary used in docs/example.md:36-40.
"""

from __future__ import annotations

import zlib

import numpy as np

from .bitmagic import BitMagicFormatError, deserialize, serialize

MAGIC = b"#msweep-tpu-pack"

#: reads per serialized chunk; alignment-writer packs its input in chunks
#: so that unpacking can stream.  The exact reference chunk size is a
#: buffering detail that does not affect the format (chunks OR together).
CHUNK_READS = 100_000


def looks_packed(buf: bytes) -> bool:
    """Autodetect like the reference: ',' in the first line
    (include/mSWEEP_alignment.hpp:103)."""
    nl = buf.find(b"\n")
    first = buf[: nl if nl >= 0 else len(buf)]
    return b"," in first


def read_header(line: bytes) -> tuple[int, int]:
    """alignment_writer::ReadHeader equivalent: 'n_reads,n_refs'."""
    parts = line.strip().split(b",")
    if len(parts) != 2:
        raise ValueError(f"invalid packed alignment header: {line!r}")
    return int(parts[0]), int(parts[1])


def pack_pairs(
    read_ids: np.ndarray,
    target_ids: np.ndarray,
    n_reads: int,
    n_refs: int,
    level: int = 6,  # accepted for CLI compat; BitMagic blocks are not leveled
) -> bytes:
    """Pack (read, target) pairs into the alignment-writer .aln format."""
    del level
    keys = np.unique(
        read_ids.astype(np.uint64) * np.uint64(n_refs) + target_ids.astype(np.uint64)
    )
    size = n_reads * n_refs
    out = bytearray(f"{n_reads},{n_refs}\n".encode())
    chunk_keys = np.uint64(CHUNK_READS) * np.uint64(n_refs)
    n_chunks = max(1, -(-n_reads // CHUNK_READS))
    lo = 0
    for c in range(n_chunks):
        hi_key = (c + 1) * chunk_keys
        hi = int(np.searchsorted(keys, hi_key, side="left"))
        blob = serialize(keys[lo:hi], size)
        out += f"{len(blob)}\n".encode()
        out += blob
        lo = hi
        if lo >= len(keys) and c >= 0:
            break
    return bytes(out)


def _parse_legacy_v1(buf: bytes, nl1: int, n_refs: int, n_reads: int):
    nl2 = buf.find(b"\n", nl1 + 1)
    meta = buf[nl1 + 1 : nl2]
    fields = meta.split(b"\t")
    if fields[1] != b"v1":
        raise ValueError(f"unsupported msweep-tpu-pack version {fields[1]!r}")
    n_pairs = int(fields[2])
    deltas = np.frombuffer(zlib.decompress(buf[nl2 + 1 :]), dtype="<u8")
    if len(deltas) != n_pairs:
        raise ValueError("packed alignment payload is truncated")
    keys = np.cumsum(deltas, dtype=np.uint64)
    return keys // np.uint64(n_refs), keys % np.uint64(n_refs), n_reads


def parse_packed_pairs(buf: bytes, expected_n_refs: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Unpack to (read_ids, target_ids, n_reads) like the plaintext parser.

    Raises with the reference's wording when target counts mismatch
    (include/mSWEEP_alignment.hpp:107-111).
    """
    nl1 = buf.find(b"\n")
    n_reads, n_refs = read_header(buf[:nl1])
    if n_refs > expected_n_refs:
        raise ValueError("Pseudoalignment file has more target sequences than expected.")
    if n_refs < expected_n_refs:
        raise ValueError("Pseudoalignment file has less target sequences than expected.")

    if buf[nl1 + 1 : nl1 + 1 + len(MAGIC)] == MAGIC:
        return _parse_legacy_v1(buf, nl1, n_refs, n_reads)

    # alignment-writer framing: repeated "<bytes>\n<blob>" chunks.
    pos = nl1 + 1
    chunks: list[np.ndarray] = []
    while pos < len(buf):
        nl = buf.find(b"\n", pos)
        if nl < 0:
            if buf[pos:].strip() == b"":
                break
            raise ValueError("truncated packed alignment chunk header")
        line = buf[pos:nl].strip()
        if not line:
            pos = nl + 1
            continue
        try:
            n_bytes = int(line)
        except ValueError as e:
            raise ValueError(
                f"invalid packed alignment chunk size line {line[:40]!r}"
            ) from e
        blob = buf[nl + 1 : nl + 1 + n_bytes]
        if len(blob) != n_bytes:
            raise ValueError("packed alignment chunk is truncated")
        try:
            positions, _ = deserialize(blob, size_hint=n_reads * n_refs)
        except BitMagicFormatError as e:
            raise ValueError(f"cannot decode packed alignment chunk: {e}") from e
        chunks.append(positions)
        pos = nl + 1 + n_bytes

    keys = (
        np.unique(np.concatenate(chunks))
        if chunks
        else np.empty(0, dtype=np.uint64)
    )
    return keys // np.uint64(n_refs), keys % np.uint64(n_refs), n_reads

"""BitMagic bvector (de)serialization — the subset alignment-writer uses.

The reference consumes `.aln` files produced by the external
`alignment-writer` library: a ``"n_reads,n_refs"`` header line followed by
size-framed chunks, each chunk being one serialized BitMagic
``bm::bvector<>`` holding bits ``read*n_refs + target`` for a range of
reads (the reference's `include/mSWEEP_alignment.hpp:103-114` calls
``alignment_writer::ReadHeader`` + ``alignment_writer::UnpackData``, which
in turn calls ``bm::deserialize`` to OR each chunk into the accumulating
vector).  Neither library ships in the snapshot (both are CMake
FetchContent deps), so this module reimplements the *wire format* from the
BitMagic serialization layout (bmserial.h, BitMagic v7.x — the version
vendored by alignment-writer v0.5.0 per the reference CMakeLists):

Stream layout::

    u8   header_flags        (BM_HM_* mask below)
    u8   byte_order          (unless NO_BO; 1 = little-endian)
    u16  gap_levels[4]       (unless NO_GAPL; informational)
    u32/u64 bv_size          (if RESIZE; u64 iff 64_BIT)
    then a sequence of block ops (opcodes below) covering 64Kbit blocks
    in ascending block order, terminated by set_block_end / *azero/*aone.

Everything here is an original reconstruction — no BitMagic code was
available or copied; opcode names mirror the public bmserial.h constants
because they ARE the wire contract.  Confidence notes:

- structural ops (end/zero/one runs, plain GAP, bit, arrays, intervals,
  0-runs, 1bit) — high confidence; byte-level fixtures in
  tests/test_bitmagic.py pin the layout.
- Elias-gamma ops (gap_egamma, arrgap_egamma[_inv]) — medium confidence
  (bit order LSB-first in little-endian u32 words; first array element
  coded as value+1, rest as deltas).
- binary-interpolative v1 ops (arr_bienc[_inv], gap_bienc,
  bitgap_bienc) — medium-LOW confidence: the recursive mid-first BIC
  structure with range tightening is the published Moffat-Stuiver
  algorithm (high confidence), but the minimal-binary sub-code layout
  (_bic_* below: short-codes-first minimal binary, LSB-first bit
  order) is a reconstruction that could not be validated against a
  real BitMagic build offline.  Byte-level fixtures in
  tests/test_bitmagic.py pin THIS layout; re-validate against
  bm::deserialize the moment a BitMagic build is obtainable.  A
  derailed bitstream surfaces as a range violation or a bad follow-on
  opcode (BitMagicFormatError), not silent corruption, because BIC
  decode is range-checked at every split.
- bienc V2 ops (gap/arr/arr_inv/bitgap _bienc_v2) — medium-LOW
  confidence, same caveat as v1: the v2 re-pack keeps the BIC payload
  but shrinks the header, storing min_v and the tail delta
  (65535 - max_v) as single bytes — v2 opcodes are only emitted when
  both fit in 8 bits, else the serializer falls back to the v1 opcode.
  Byte-level fixtures pin this layout; re-validate against a real
  bm::deserialize when obtainable.
- digest0 (set_block_bit_digest0) — high-MEDIUM confidence: u64 digest
  bitmask over the 64 1024-bit waves of the block, followed by the raw
  u32 words of each nonzero wave in ascending order.
- sblock_bienc, arr_bienc_8bh, XOR-ref ops, and bookmarks — NOT
  supported: a clear error names the opcode and the re-pack
  workaround.  (XOR-ref and bookmarks are opt-in serializer features
  alignment-writer never enables; sblock/8bh paths could not be
  reconstructed offline.)

The `serialize` encoder emits only conservative, long-stable opcodes
(zero runs, plain GAP/bit/array blocks) so that any BitMagic build can
read files packed by msweep-tpu; see COMPAT.md section 5.
"""

from __future__ import annotations

import numpy as np

# -- header flags (bmserial.h serialization_header_mask) --------------------
BM_HM_DEFAULT = 1  # size == bm::id_max (no explicit size field)
BM_HM_RESIZE = 1 << 1  # explicit bv size follows
BM_HM_ID_LIST = 1 << 2  # payload is a plain id list, no blocks
BM_HM_NO_BO = 1 << 3  # no byte-order byte
BM_HM_NO_GAPL = 1 << 4  # no GAP-level table
BM_HM_64_BIT = 1 << 5  # 64-bit address mode (alignment-writer uses bm64.h)
BM_HM_HXOR = 1 << 6  # horizontal XOR compression (unsupported here)
BM_HM_SPARSE = 1 << 7  # sparse serialization mode (unsupported here)

# -- block opcodes (bmserial.h serialization codes) --------------------------
SET_BLOCK_END = 0
SET_BLOCK_1ZERO = 1
SET_BLOCK_1ONE = 2
SET_BLOCK_8ZERO = 3  # run of zero blocks, u8 payload = count-1
SET_BLOCK_8ONE = 4
SET_BLOCK_16ZERO = 5  # u16 payload = count-1
SET_BLOCK_16ONE = 6
SET_BLOCK_32ZERO = 7  # u32 payload = count-1
SET_BLOCK_32ONE = 8
SET_BLOCK_AZERO = 9  # all remaining blocks zero
SET_BLOCK_AONE = 10
SET_BLOCK_BIT = 11  # raw bit block: 2048 little-endian u32
SET_BLOCK_SGAPBIT = 12  # legacy s-gap (never emitted by v7 serializers)
SET_BLOCK_SGAPGAP = 13
SET_BLOCK_GAP = 14  # plain GAP block: u16 head + (len-2) u16 boundaries
SET_BLOCK_GAPBIT = 15  # bit block stored GAP-coded (same payload as GAP)
SET_BLOCK_ARRBIT = 16  # u16 count + count u16 set-bit positions
SET_BLOCK_BIT_INTERVAL = 17  # u16 first, u16 last (inclusive)
SET_BLOCK_ARRGAP = 18  # u16 count + count u16 set-bit positions
SET_BLOCK_BIT_1BIT = 19  # u16 position
SET_BLOCK_GAP_EGAMMA = 20  # gamma-coded GAP block
SET_BLOCK_ARRGAP_EGAMMA = 21  # gamma-coded set-bit position array
SET_BLOCK_BIT_0RUNS = 22  # bit block as alternating zero/nonzero word runs
SET_BLOCK_ARRGAP_EGAMMA_INV = 23  # gamma-coded CLEAR-bit position array
SET_BLOCK_ARRGAP_INV = 24  # u16 count + count u16 clear-bit positions
SET_BLOCK_64ZERO = 25  # u64 payload = count-1
SET_BLOCK_64ONE = 26
SET_BLOCK_ARR_BIENC = 27  # BIC-coded set-bit position array
SET_BLOCK_ARR_BIENC_INV = 28  # BIC-coded clear-bit position array
SET_BLOCK_GAP_BIENC = 29  # BIC-coded GAP block
SET_BLOCK_BITGAP_BIENC = 30
SET_BLOCK_BIT_DIGEST0 = 31  # digest-masked raw sub-blocks
SET_NB_BOOKMARK16 = 32
SET_NB_BOOKMARK24 = 33
SET_NB_BOOKMARK32 = 34
SET_NB_SYNC_MARK8 = 35
SET_NB_SYNC_MARK16 = 36
SET_NB_SYNC_MARK24 = 37
SET_NB_SYNC_MARK32 = 38
SET_NB_SYNC_MARK48 = 39
SET_NB_SYNC_MARK64 = 40
SET_SBLOCK_BIENC = 41
SET_BLOCK_ARR_BIENC_8BH = 42
SET_BLOCK_XOR_REF8 = 43
SET_BLOCK_XOR_REF16 = 44
SET_BLOCK_XOR_REF32 = 45
SET_BLOCK_XOR_GAP_REF8 = 46
SET_BLOCK_XOR_GAP_REF16 = 47
SET_BLOCK_XOR_GAP_REF32 = 48
SET_BLOCK_XOR_CHAIN = 49
SET_BLOCK_GAP_BIENC_V2 = 50
SET_BLOCK_ARR_BIENC_V2 = 51
SET_BLOCK_ARR_BIENC_INV_V2 = 52
SET_BLOCK_BITGAP_BIENC_V2 = 53

BLOCK_BITS = 65536  # bits per BitMagic block
BLOCK_WORDS = 2048  # u32 words per block
GAP_MAX_BITS = 65536
_DEFAULT_GAP_LEVELS = (128, 256, 512, 1280)  # bm::gap_len_table defaults


class BitMagicFormatError(ValueError):
    """Raised when a stream is malformed or uses an unsupported feature."""


def _strict_mode() -> bool:
    """MSWEEP_BM_STRICT=1 refuses the medium-LOW-confidence opcodes
    (bienc v1/v2, digest0) whose reconstructed bit layout has not been
    validated against a real bm::deserialize (COMPAT.md section 5) —
    restoring the hard unsupported-opcode error for users who prefer a
    loud failure over a small risk of plausible-looking mis-decode."""
    import os

    return os.environ.get("MSWEEP_BM_STRICT", "") == "1"


def _strict_reject(op: int, pos: int) -> None:
    if _strict_mode():
        raise BitMagicFormatError(
            f"BitMagic opcode {op} at byte {pos} uses a reconstructed "
            "bit layout not yet validated against a real BitMagic build "
            "and MSWEEP_BM_STRICT=1 is set; unset it to accept, or "
            "re-pack the alignment with a lower compression level"
        )


# ---------------------------------------------------------------------------
# primitive readers
# ---------------------------------------------------------------------------

class _Dec:
    """Little-endian byte-stream reader over a memoryview."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf, pos: int = 0):
        self.buf = memoryview(buf)
        self.pos = pos

    def _take(self, n: int) -> memoryview:
        p = self.pos
        if p + n > len(self.buf):
            raise BitMagicFormatError("truncated BitMagic stream")
        self.pos = p + n
        return self.buf[p : p + n]

    def u8(self) -> int:
        return self._take(1)[0]

    def u16(self) -> int:
        b = self._take(2)
        return b[0] | (b[1] << 8)

    def u32(self) -> int:
        return int.from_bytes(self._take(4), "little")

    def u64(self) -> int:
        return int.from_bytes(self._take(8), "little")

    def u16_array(self, n: int) -> np.ndarray:
        return np.frombuffer(self._take(2 * n), dtype="<u2").astype(np.uint32)

    def u32_array(self, n: int) -> np.ndarray:
        return np.frombuffer(self._take(4 * n), dtype="<u4")


class _BitIn:
    """LSB-first bit reader over little-endian u32 words (bm::bit_in).

    Bits are consumed from bit 0 of each u32 upward; the writer flushes
    partial words zero-padded, so after use the decoder position advances
    by a whole number of u32s.
    """

    __slots__ = ("dec", "acc", "used")

    def __init__(self, dec: _Dec):
        self.dec = dec
        self.acc = 0
        self.used = 32  # force first refill

    def _bit(self) -> int:
        if self.used == 32:
            self.acc = self.dec.u32()
            self.used = 0
        b = (self.acc >> self.used) & 1
        self.used += 1
        return b

    def bits(self, n: int) -> int:
        v = 0
        for i in range(n):
            v |= self._bit() << i
        return v

    def gamma(self) -> int:
        logv = 0
        while self._bit() == 0:
            logv += 1
            if logv > 32:
                raise BitMagicFormatError("bad gamma code")
        return (1 << logv) | self.bits(logv)


class _BitOut:
    """Writer matching _BitIn."""

    __slots__ = ("out", "acc", "used")

    def __init__(self, out: bytearray):
        self.out = out
        self.acc = 0
        self.used = 0

    def bit(self, v: int) -> None:
        self.acc |= (v & 1) << self.used
        self.used += 1
        if self.used == 32:
            self.out += self.acc.to_bytes(4, "little")
            self.acc = 0
            self.used = 0

    def bits(self, v: int, n: int) -> None:
        for i in range(n):
            self.bit((v >> i) & 1)

    def gamma(self, v: int) -> None:
        assert v >= 1
        logv = v.bit_length() - 1
        self.bits(0, logv)
        self.bit(1)
        self.bits(v & ((1 << logv) - 1), logv)

    def flush(self) -> None:
        if self.used:
            self.out += self.acc.to_bytes(4, "little")
            self.acc = 0
            self.used = 0


# ---------------------------------------------------------------------------
# block payload decoders -> in-block set-bit positions (u32 array)
# ---------------------------------------------------------------------------

_FULL_BLOCK = np.arange(BLOCK_BITS, dtype=np.uint32)


def _multi_arange(starts: np.ndarray, stops: np.ndarray) -> np.ndarray:
    """Concatenated [s, e) ranges, vectorized."""
    lens = (stops - starts).astype(np.int64)
    keep = lens > 0
    starts, lens = starts[keep].astype(np.int64), lens[keep]
    if not len(starts):
        return np.empty(0, dtype=np.uint32)
    total = int(lens.sum())
    out = np.ones(total, dtype=np.int64)
    out[0] = starts[0]
    ends = np.cumsum(lens)[:-1]
    out[ends] = starts[1:] - (starts[:-1] + lens[:-1] - 1)
    return np.cumsum(out).astype(np.uint32)


def _gap_to_positions(head: int, boundaries: np.ndarray) -> np.ndarray:
    """Expand a GAP block (run-length) to set-bit positions.

    `boundaries` = inclusive run-end positions INCLUDING the 65535
    terminator; head bit0 = value of the first run.
    """
    first_val = head & 1
    ends = boundaries.astype(np.int64) + 1  # exclusive
    starts = np.concatenate([[0], ends[:-1]])
    if first_val:
        one_idx = np.arange(0, len(ends), 2)
    else:
        one_idx = np.arange(1, len(ends), 2)
    return _multi_arange(starts[one_idx], ends[one_idx])


def _decode_gap_payload(dec: _Dec) -> np.ndarray:
    head = dec.u16()
    total = (head >> 3) + 1  # words incl head and implied terminator
    if total < 2:
        raise BitMagicFormatError("bad GAP block header")
    body = dec.u16_array(total - 2)
    boundaries = np.concatenate([body, [GAP_MAX_BITS - 1]]).astype(np.uint32)
    return _gap_to_positions(head, boundaries)


def _decode_gap_egamma_payload(dec: _Dec) -> np.ndarray:
    head = dec.u16()
    total = (head >> 3) + 1
    n_deltas = total - 2  # boundaries except the implied terminator
    bin_ = _BitIn(dec)
    vals = np.empty(n_deltas, dtype=np.int64)
    v = 0
    for k in range(n_deltas):
        v += bin_.gamma()
        vals[k] = v - 1
    boundaries = np.concatenate([vals, [GAP_MAX_BITS - 1]]).astype(np.uint32)
    return _gap_to_positions(head, boundaries)


def _decode_egamma_array(dec: _Dec) -> np.ndarray:
    """Gamma-coded position array: gamma(len), gamma(first+1), gamma deltas."""
    bin_ = _BitIn(dec)
    n = bin_.gamma()
    out = np.empty(n, dtype=np.int64)
    prev = 0
    for k in range(n):
        v = bin_.gamma()
        if k == 0:
            v -= 1
        prev = prev + v if k else v
        out[k] = prev
    return out.astype(np.uint32)


# -- binary interpolative coding (BIC) ---------------------------------------
#
# Moffat & Stuiver (2000) interpolative coding of a sorted array: emit the
# middle element with a minimal binary code over its feasible range
# (tightened by how many elements sit on each side), then recurse on both
# halves.  Sub-code layout [reconstructed, see module docstring]: for a
# value x in the inclusive range [lo, hi] with n = hi-lo+1 codewords,
# b = ceil(log2 n) and d = 2^b - n values get SHORT (b-1)-bit codes,
# assigned to the first d offsets; the rest get b-bit codes offset by d.
# Bits go LSB-first into little-endian u32 words (_BitIn/_BitOut).


def _bic_read_value(bin_: _BitIn, lo: int, hi: int) -> int:
    """Minimal binary code for a value in [lo, hi], LSB-first-safe:
    with n codewords, b = ceil(log2 n) and d = 2^b - n values get SHORT
    (b-1)-bit codes [0, d); the n-d long values pair up on the remaining
    (b-1)-bit prefixes [d, 2^(b-1)) plus one disambiguating bit (read
    AFTER the prefix, so the code is prefix-free in read order)."""
    n = hi - lo + 1
    if n <= 1:
        return lo
    b = (n - 1).bit_length()  # ceil(log2 n) for n >= 2
    d = (1 << b) - n
    y = bin_.bits(b - 1)
    if y < d:
        return lo + y
    t = bin_._bit()
    return lo + d + (((y - d) << 1) | t)


def _bic_write_value(bout: _BitOut, x: int, lo: int, hi: int) -> None:
    n = hi - lo + 1
    assert lo <= x <= hi
    if n <= 1:
        return
    b = (n - 1).bit_length()
    d = (1 << b) - n
    c = x - lo
    if c < d:
        bout.bits(c, b - 1)
    else:
        q, t = divmod(c - d, 2)
        bout.bits(d + q, b - 1)
        bout.bit(t)


def _bic_decode(bin_: _BitIn, sz: int, lo: int, hi: int, out: list) -> None:
    """Decode sz sorted values in [lo, hi].  Recursive with bounded
    depth: BIC splits at the middle, so depth <= ~17 for 64K values."""

    def rec(sz, lo, hi):
        if sz <= 0:
            return []
        if lo > hi or hi - lo + 1 < sz:
            raise BitMagicFormatError("BIC range violation (corrupt stream?)")
        mid = sz >> 1
        vlo = lo + mid  # mid has `mid` elements below it...
        vhi = hi - (sz - mid - 1)  # ...and sz-mid-1 above
        val = _bic_read_value(bin_, vlo, vhi)
        left = rec(mid, lo, val - 1)
        right = rec(sz - mid - 1, val + 1, hi)
        return left + [val] + right

    out.extend(rec(sz, lo, hi))


def _bic_encode(bout: _BitOut, arr, lo: int, hi: int) -> None:
    def rec(a, lo, hi):
        sz = len(a)
        if not sz:
            return
        mid = sz >> 1
        val = int(a[mid])
        _bic_write_value(bout, val, lo + mid, hi - (sz - mid - 1))
        rec(a[:mid], lo, val - 1)
        rec(a[mid + 1 :], val + 1, hi)

    rec(list(arr), lo, hi)


def _decode_bienc_array(dec: _Dec) -> np.ndarray:
    """set_block_arr_bienc payload: u16 min, u16 max, u16 count, then a
    BIC bitstream of the count-2 interior values in (min, max)."""
    min_v = dec.u16()
    max_v = dec.u16()
    n = dec.u16()
    if n < 2 or max_v < min_v or n > max_v - min_v + 1:
        raise BitMagicFormatError("bad bienc array header")
    vals: list = []
    if n > 2:
        bin_ = _BitIn(dec)
        _bic_decode(bin_, n - 2, min_v + 1, max_v - 1, vals)
    return np.asarray([min_v] + vals + [max_v], dtype=np.uint32)


def _decode_gap_bienc_payload(dec: _Dec) -> np.ndarray:
    """set_block_gap_bienc payload: u16 GAP head, u16 first boundary,
    then a BIC bitstream of the remaining boundaries except the implied
    65535 terminator."""
    head = dec.u16()
    total = (head >> 3) + 1  # words incl head and implied terminator
    if total < 3:
        raise BitMagicFormatError("bad bienc GAP block header")
    min_v = dec.u16()
    vals: list = [min_v]
    n_rest = total - 3  # boundaries after the first, before terminator
    if n_rest > 0:
        bin_ = _BitIn(dec)
        _bic_decode(bin_, n_rest, min_v + 1, GAP_MAX_BITS - 2, vals)
    boundaries = np.asarray(vals + [GAP_MAX_BITS - 1], dtype=np.uint32)
    return _gap_to_positions(head, boundaries)


def _decode_bienc_array_v2(dec: _Dec) -> np.ndarray:
    """set_block_arr_bienc_v2 payload: u8 min, u8 tail_delta
    (max = 65535 - tail_delta), u16 count, then the same BIC bitstream
    as v1 over the count-2 interior values in (min, max)."""
    min_v = dec.u8()
    max_v = (BLOCK_BITS - 1) - dec.u8()
    n = dec.u16()
    if n < 2 or max_v < min_v or n > max_v - min_v + 1:
        raise BitMagicFormatError("bad bienc-v2 array header")
    vals: list = []
    if n > 2:
        bin_ = _BitIn(dec)
        _bic_decode(bin_, n - 2, min_v + 1, max_v - 1, vals)
    return np.asarray([min_v] + vals + [max_v], dtype=np.uint32)


def _decode_gap_bienc_v2_payload(dec: _Dec) -> np.ndarray:
    """set_block_gap_bienc_v2 payload: u16 GAP head (level bits ignored),
    u8 first boundary, u8 tail delta (last explicit boundary =
    65535 - delta), then a BIC bitstream of the interior boundaries.
    Requires >= 2 explicit boundaries (the encoder falls back to the v1
    opcode otherwise)."""
    head = dec.u16()
    total = (head >> 3) + 1  # words incl head and implied terminator
    if total < 4:
        raise BitMagicFormatError("bad bienc-v2 GAP block header")
    min_v = dec.u8()
    max_v = (GAP_MAX_BITS - 1) - dec.u8()
    # A tail delta of 0 would duplicate the implied 65535 terminator —
    # a corrupt (or mis-framed) stream, rejected loudly like the BIC
    # range checks.
    if max_v <= min_v or max_v >= GAP_MAX_BITS - 1:
        raise BitMagicFormatError("bad bienc-v2 GAP block bounds")
    vals: list = [min_v]
    n_interior = total - 4  # after the first, before the last + terminator
    if n_interior > 0:
        bin_ = _BitIn(dec)
        _bic_decode(bin_, n_interior, min_v + 1, max_v - 1, vals)
    boundaries = np.asarray(vals + [max_v, GAP_MAX_BITS - 1], dtype=np.uint32)
    if np.any(boundaries[1:] <= boundaries[:-1]):
        raise BitMagicFormatError("bienc-v2 GAP boundaries not increasing")
    return _gap_to_positions(head, boundaries)


_DIGEST_WAVE_WORDS = BLOCK_WORDS // 64  # 32 u32 words = 1024 bits per wave


def _decode_bit_digest0(dec: _Dec) -> np.ndarray:
    """set_block_bit_digest0 payload: u64 digest (bit d set = wave d has
    nonzero words), then the raw u32 words of each nonzero wave in
    ascending wave order."""
    digest = dec.u64()
    words = np.zeros(BLOCK_WORDS, dtype="<u4")
    for d in range(64):
        if (digest >> d) & 1:
            words[d * _DIGEST_WAVE_WORDS : (d + 1) * _DIGEST_WAVE_WORDS] = (
                dec.u32_array(_DIGEST_WAVE_WORDS)
            )
    return _words_to_positions(words)


def _encode_bienc_array_v2(out: bytearray, pos: np.ndarray) -> None:
    """Fixture-side encoder mirroring _decode_bienc_array_v2 exactly."""
    assert len(pos) >= 2
    min_v, max_v = int(pos[0]), int(pos[-1])
    assert min_v < 256 and (BLOCK_BITS - 1) - max_v < 256
    out.append(min_v)
    out.append((BLOCK_BITS - 1) - max_v)
    out += len(pos).to_bytes(2, "little")
    if len(pos) > 2:
        bout = _BitOut(out)
        _bic_encode(bout, [int(p) for p in pos[1:-1]], min_v + 1, max_v - 1)
        bout.flush()


def _encode_gap_bienc_v2(out: bytearray, head: int, boundaries: np.ndarray) -> None:
    """Fixture-side encoder mirroring _decode_gap_bienc_v2_payload (the
    boundaries array INCLUDES the 65535 terminator)."""
    assert len(boundaries) >= 3  # min, max, terminator
    min_v, max_v = int(boundaries[0]), int(boundaries[-2])
    assert min_v < 256 and (GAP_MAX_BITS - 1) - max_v < 256
    out += int(head).to_bytes(2, "little")
    out.append(min_v)
    out.append((GAP_MAX_BITS - 1) - max_v)
    interior = [int(b) for b in boundaries[1:-2]]
    if interior:
        bout = _BitOut(out)
        _bic_encode(bout, interior, min_v + 1, max_v - 1)
        bout.flush()


def _encode_bit_digest0(out: bytearray, pos: np.ndarray) -> None:
    """Fixture-side encoder mirroring _decode_bit_digest0 exactly."""
    words = np.zeros(BLOCK_WORDS, dtype="<u4")
    np.bitwise_or.at(
        words, pos >> 5, np.left_shift(np.uint32(1), (pos & 31).astype(np.uint32))
    )
    waves = words.reshape(64, _DIGEST_WAVE_WORDS)
    nonzero = waves.any(axis=1)
    digest = 0
    for d in np.flatnonzero(nonzero):
        digest |= 1 << int(d)
    out += digest.to_bytes(8, "little")
    for d in np.flatnonzero(nonzero):
        out += waves[d].tobytes()


def _encode_bienc_array(out: bytearray, pos: np.ndarray) -> None:
    """Fixture-side encoder mirroring _decode_bienc_array exactly."""
    assert len(pos) >= 2
    out += int(pos[0]).to_bytes(2, "little")
    out += int(pos[-1]).to_bytes(2, "little")
    out += len(pos).to_bytes(2, "little")
    if len(pos) > 2:
        bout = _BitOut(out)
        _bic_encode(bout, [int(p) for p in pos[1:-1]], int(pos[0]) + 1, int(pos[-1]) - 1)
        bout.flush()


def _encode_gap_bienc(out: bytearray, head: int, boundaries: np.ndarray) -> None:
    """Fixture-side encoder mirroring _decode_gap_bienc_payload (the
    boundaries array INCLUDES the 65535 terminator, like _gap_to_positions
    takes)."""
    out += int(head).to_bytes(2, "little")
    min_v = int(boundaries[0])
    out += min_v.to_bytes(2, "little")
    rest = [int(b) for b in boundaries[1:-1]]
    if rest:
        bout = _BitOut(out)
        _bic_encode(bout, rest, min_v + 1, GAP_MAX_BITS - 2)
        bout.flush()


def _decode_bit_0runs(dec: _Dec) -> np.ndarray:
    """Alternating zero/nonzero u32-word runs (set_block_bit_0runs)."""
    words = np.zeros(BLOCK_WORDS, dtype="<u4")
    run_type = dec.u8()
    j = 0
    while j < BLOCK_WORDS:
        run_len = dec.u16()
        if run_type:
            words[j : j + run_len] = dec.u32_array(run_len)
        j += run_len
        run_type = not run_type
    return _words_to_positions(words)


def _words_to_positions(words: np.ndarray) -> np.ndarray:
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return np.flatnonzero(bits).astype(np.uint32)


def _invert_positions(pos: np.ndarray) -> np.ndarray:
    mask = np.ones(BLOCK_BITS, dtype=bool)
    mask[pos] = False
    return np.flatnonzero(mask).astype(np.uint32)


# ---------------------------------------------------------------------------
# stream decode
# ---------------------------------------------------------------------------

def deserialize(buf, size_hint: int | None = None) -> tuple[np.ndarray, int]:
    """Decode one serialized bvector.

    Returns ``(positions, bv_size)`` where positions is a sorted u64 array
    of set-bit indices.  Equivalent to ``bm::deserialize`` into an empty
    vector (the caller ORs chunks together, as UnpackData does).
    """
    dec = _Dec(buf)
    flags = dec.u8()
    if flags & BM_HM_HXOR:
        raise BitMagicFormatError(
            "BitMagic stream uses XOR-reference compression, which "
            "msweep-tpu does not support (opt-in serializer feature)"
        )
    if flags & BM_HM_SPARSE:
        raise BitMagicFormatError(
            "BitMagic sparse serialization mode is not supported"
        )
    if not flags & BM_HM_NO_BO:
        bo = dec.u8()
        if bo != 1:
            raise BitMagicFormatError(f"big-endian BitMagic stream (bo={bo})")
    if not flags & BM_HM_NO_GAPL:
        for _ in range(4):
            dec.u16()  # gap level table, informational
    is64 = bool(flags & BM_HM_64_BIT)
    if flags & BM_HM_RESIZE:
        bv_size = dec.u64() if is64 else dec.u32()
    else:
        bv_size = size_hint if size_hint is not None else (1 << 48 if is64 else (1 << 32) - 1)

    if flags & BM_HM_ID_LIST:
        cnt = dec.u32()
        ids = np.array(
            [dec.u64() if is64 else dec.u32() for _ in range(cnt)], dtype=np.uint64
        )
        return np.sort(ids), bv_size

    n_blocks = (bv_size + BLOCK_BITS - 1) // BLOCK_BITS
    chunks: list[np.ndarray] = []
    i = 0  # current block index

    def emit(block_idx: int, pos: np.ndarray) -> None:
        if len(pos):
            chunks.append(block_idx * np.uint64(BLOCK_BITS) + pos.astype(np.uint64))

    def emit_full(first: int, count: int) -> None:
        for b in range(first, first + count):
            emit(b, _FULL_BLOCK)

    while True:
        op = dec.u8()
        if op == SET_BLOCK_END:
            break
        elif op == SET_BLOCK_1ZERO:
            i += 1
        elif op == SET_BLOCK_1ONE:
            emit_full(i, 1)
            i += 1
        elif op in (SET_BLOCK_8ZERO, SET_BLOCK_16ZERO, SET_BLOCK_32ZERO, SET_BLOCK_64ZERO):
            n = {3: dec.u8, 5: dec.u16, 7: dec.u32, 25: dec.u64}[op]() + 1
            i += n
        elif op in (SET_BLOCK_8ONE, SET_BLOCK_16ONE, SET_BLOCK_32ONE, SET_BLOCK_64ONE):
            n = {4: dec.u8, 6: dec.u16, 8: dec.u32, 26: dec.u64}[op]() + 1
            emit_full(i, n)
            i += n
        elif op == SET_BLOCK_AZERO:
            break
        elif op == SET_BLOCK_AONE:
            while i < n_blocks:
                hi = min(BLOCK_BITS, bv_size - i * BLOCK_BITS)
                emit(i, _FULL_BLOCK[:hi])
                i += 1
            break
        elif op == SET_BLOCK_BIT:
            emit(i, _words_to_positions(dec.u32_array(BLOCK_WORDS)))
            i += 1
        elif op in (SET_BLOCK_GAP, SET_BLOCK_GAPBIT):
            emit(i, _decode_gap_payload(dec))
            i += 1
        elif op in (SET_BLOCK_ARRBIT, SET_BLOCK_ARRGAP):
            n = dec.u16()
            emit(i, dec.u16_array(n))
            i += 1
        elif op == SET_BLOCK_ARRGAP_INV:
            n = dec.u16()
            emit(i, _invert_positions(dec.u16_array(n)))
            i += 1
        elif op == SET_BLOCK_BIT_INTERVAL:
            lo, hi = dec.u16(), dec.u16()
            emit(i, np.arange(lo, hi + 1, dtype=np.uint32))
            i += 1
        elif op == SET_BLOCK_BIT_1BIT:
            emit(i, np.array([dec.u16()], dtype=np.uint32))
            i += 1
        elif op == SET_BLOCK_GAP_EGAMMA:
            emit(i, _decode_gap_egamma_payload(dec))
            i += 1
        elif op == SET_BLOCK_ARRGAP_EGAMMA:
            emit(i, _decode_egamma_array(dec))
            i += 1
        elif op == SET_BLOCK_ARRGAP_EGAMMA_INV:
            emit(i, _invert_positions(_decode_egamma_array(dec)))
            i += 1
        elif op == SET_BLOCK_BIT_0RUNS:
            emit(i, _decode_bit_0runs(dec))
            i += 1
        elif op == SET_BLOCK_ARR_BIENC:
            _strict_reject(op, dec.pos - 1)
            emit(i, _decode_bienc_array(dec))
            i += 1
        elif op == SET_BLOCK_ARR_BIENC_INV:
            _strict_reject(op, dec.pos - 1)
            emit(i, _invert_positions(_decode_bienc_array(dec)))
            i += 1
        elif op in (SET_BLOCK_GAP_BIENC, SET_BLOCK_BITGAP_BIENC):
            _strict_reject(op, dec.pos - 1)
            emit(i, _decode_gap_bienc_payload(dec))
            i += 1
        elif op == SET_BLOCK_ARR_BIENC_V2:
            _strict_reject(op, dec.pos - 1)
            emit(i, _decode_bienc_array_v2(dec))
            i += 1
        elif op == SET_BLOCK_ARR_BIENC_INV_V2:
            _strict_reject(op, dec.pos - 1)
            emit(i, _invert_positions(_decode_bienc_array_v2(dec)))
            i += 1
        elif op in (SET_BLOCK_GAP_BIENC_V2, SET_BLOCK_BITGAP_BIENC_V2):
            _strict_reject(op, dec.pos - 1)
            emit(i, _decode_gap_bienc_v2_payload(dec))
            i += 1
        elif op == SET_BLOCK_BIT_DIGEST0:
            _strict_reject(op, dec.pos - 1)
            emit(i, _decode_bit_digest0(dec))
            i += 1
        else:
            raise BitMagicFormatError(
                f"unsupported BitMagic block opcode {op} at byte {dec.pos - 1} "
                "(XOR-ref/sblock/bookmark block; re-pack the alignment with "
                "`msweep-tpu pack` or alignment-writer "
                "--compression-level <=3)"
            )
        if i > n_blocks + 1:
            raise BitMagicFormatError("block index overran vector size")

    if chunks:
        positions = np.concatenate(chunks)
    else:
        positions = np.empty(0, dtype=np.uint64)
    return positions, bv_size


# ---------------------------------------------------------------------------
# stream encode (conservative opcode subset)
# ---------------------------------------------------------------------------

def _encode_zero_run(out: bytearray, n: int) -> None:
    while n:
        if n == 1:
            out.append(SET_BLOCK_1ZERO)
            n = 0
        elif n <= 256:
            out.append(SET_BLOCK_8ZERO)
            out.append(n - 1)
            n = 0
        elif n <= 65536:
            out.append(SET_BLOCK_16ZERO)
            out += (n - 1).to_bytes(2, "little")
            n = 0
        else:
            take = min(n, 1 << 32)
            out.append(SET_BLOCK_32ZERO)
            out += (take - 1).to_bytes(4, "little")
            n -= take


def _positions_to_gap(pos: np.ndarray) -> tuple[int, np.ndarray] | None:
    """GAP-encode in-block positions; None when it would exceed level-3
    capacity (1280 words) — the longest GAP block a default BitMagic build
    allocates, so longer blocks must go as raw bits."""
    # run boundaries: value changes at every position where membership flips
    mask = np.zeros(BLOCK_BITS + 1, dtype=bool)
    mask[pos] = True
    flips = np.flatnonzero(mask[1:] != mask[:-1])  # run ends, inclusive
    boundaries = np.concatenate([flips, [GAP_MAX_BITS - 1]]).astype(np.uint64)
    if len(boundaries) > 1 and boundaries[-2] == GAP_MAX_BITS - 1:
        boundaries = boundaries[:-1]
    total = len(boundaries) + 1  # + head word
    if total > _DEFAULT_GAP_LEVELS[-1]:
        return None
    first_val = bool(mask[0])
    level = 3
    head = (1 if first_val else 0) | (level << 1) | ((total - 1) << 3)
    return head, boundaries


def _encode_block(out: bytearray, pos: np.ndarray) -> None:
    n = len(pos)
    if n == BLOCK_BITS:
        out.append(SET_BLOCK_1ONE)
        return
    if n == 1:
        out.append(SET_BLOCK_BIT_1BIT)
        out += int(pos[0]).to_bytes(2, "little")
        return
    gap = _positions_to_gap(pos)
    arr_bytes = 2 + 2 * n
    gap_bytes = 2 * (gap[1].size + 1) if gap else 1 << 30
    if arr_bytes <= gap_bytes and n < 65536:
        out.append(SET_BLOCK_ARRGAP)
        out += n.to_bytes(2, "little")
        out += pos.astype("<u2").tobytes()
    elif gap and gap_bytes < 8192:
        head, boundaries = gap
        out.append(SET_BLOCK_GAP)
        out += head.to_bytes(2, "little")
        out += boundaries[:-1].astype("<u2").tobytes()  # terminator implied
    else:
        words = np.zeros(BLOCK_WORDS, dtype="<u4")
        np.bitwise_or.at(
            words, pos >> 5, np.left_shift(np.uint32(1), (pos & 31).astype(np.uint32))
        )
        out.append(SET_BLOCK_BIT)
        out += words.tobytes()


def serialize(positions: np.ndarray, size: int) -> bytes:
    """Serialize sorted u64 set-bit positions into a BitMagic stream.

    Output uses BM_HM_64_BIT + BM_HM_RESIZE with NO_BO/NO_GAPL (the same
    header shape alignment-writer's serializer produces) and only
    conservative block opcodes, so genuine BitMagic deserializers accept
    the stream.
    """
    positions = np.asarray(positions, dtype=np.uint64)
    out = bytearray()
    out.append(BM_HM_RESIZE | BM_HM_NO_BO | BM_HM_NO_GAPL | BM_HM_64_BIT)
    out += int(size).to_bytes(8, "little")

    if len(positions):
        block_ids = (positions >> np.uint64(16)).astype(np.int64)
        in_block = (positions & np.uint64(BLOCK_BITS - 1)).astype(np.uint32)
        uniq, starts = np.unique(block_ids, return_index=True)
        starts = np.append(starts, len(positions))
        prev = 0
        for k, b in enumerate(uniq):
            if b > prev:
                _encode_zero_run(out, int(b - prev))
            _encode_block(out, in_block[starts[k] : starts[k + 1]])
            prev = int(b) + 1
    out.append(SET_BLOCK_END)
    return bytes(out)

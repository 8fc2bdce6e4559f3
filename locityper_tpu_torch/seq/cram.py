"""CRAM 3.0 reader/writer (pure Python, no htslib).

The reference reads CRAM through htslib behind `fastx.rs:586-887`; this
module owns the format instead.  Scope:

* reader: file definition, containers, compression-header preservation /
  data-series / tag-encoding maps, slice headers, core+external blocks;
  block methods raw/gzip/bzip2/lzma (stdlib) and rANS 4x8 order-0/1;
  codecs EXTERNAL, HUFFMAN (canonical), BETA, BYTE_ARRAY_LEN,
  BYTE_ARRAY_STOP; reference-based sequence reconstruction with the
  substitution matrix and X/I/D/S/i/b/q/Q/B/H/P/N features; detached and
  downstream-mate records.
* writer: spec-compliant single-slice containers with EXTERNAL series
  (gzip blocks) — used by tests for round-trips and by users to convert
  without samtools.  Mapped records store features (BS/IN/DL/SC), unmapped
  records store verbatim bases.

Interop notes: files using CRAM 3.1 codecs (rANS Nx16, name tokeniser,
fqzcomp, adaptive arithmetic) raise a clear error naming the codec.
"""
from __future__ import annotations

import bz2
import gzip
import lzma
import struct
import zlib
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import dna
from .fastx import Read

CRAM_MAGIC = b"CRAM"

# Block compression methods.
M_RAW, M_GZIP, M_BZIP2, M_LZMA, M_RANS4x8, M_RANSNx16, M_ARITH, M_FQZ, \
    M_TOK3 = range(9)
# Block content types.
CT_FILE_HEADER, CT_COMPRESSION_HEADER, CT_SLICE_HEADER, CT_RESERVED, \
    CT_EXTERNAL, CT_CORE = range(6)

# BAM flag bits used here.
FLAG_PAIRED = 0x1
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80

# CRAM record flags (CF).
CF_QUALS = 0x1
CF_DETACHED = 0x2
CF_HAS_MATE_DOWNSTREAM = 0x4
CF_UNKNOWN_BASES = 0x8



# ---------------------------------------------------------------------------
# ITF8 / LTF8 variable-length integers
# ---------------------------------------------------------------------------

class ByteReader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def read(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n]
        if len(b) < n:
            raise ValueError("CRAM: truncated stream")
        self.pos += n
        return b

    def byte(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def eof(self) -> bool:
        return self.pos >= len(self.data)

    def itf8(self) -> int:
        b0 = self.byte()
        if b0 < 0x80:
            v = b0
        elif b0 < 0xC0:
            v = ((b0 & 0x7F) << 8) | self.byte()
        elif b0 < 0xE0:
            v = ((b0 & 0x3F) << 16) | (self.byte() << 8) | self.byte()
        elif b0 < 0xF0:
            v = ((b0 & 0x1F) << 24) | (self.byte() << 16) \
                | (self.byte() << 8) | self.byte()
        else:
            v = ((b0 & 0x0F) << 28) | (self.byte() << 20) \
                | (self.byte() << 12) | (self.byte() << 4) \
                | (self.byte() & 0x0F)
        # ITF8 stores int32: interpret as signed.
        return v - (1 << 32) if v >= (1 << 31) else v

    def ltf8(self) -> int:
        b0 = self.byte()
        n_extra = 0
        mask = 0x80
        while n_extra < 8 and (b0 & mask):
            n_extra += 1
            mask >>= 1
        if n_extra < 8:
            v = b0 & (0xFF >> n_extra)
        else:
            v = 0
        for _ in range(n_extra):
            v = (v << 8) | self.byte()
        return v - (1 << 64) if v >= (1 << 63) else v

    def itf8_array(self) -> list[int]:
        n = self.itf8()
        return [self.itf8() for _ in range(n)]


def put_itf8(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF,
                      v & 0xFF])
    return bytes([0xF0 | ((v >> 28) & 0x0F), (v >> 20) & 0xFF,
                  (v >> 12) & 0xFF, (v >> 4) & 0xFF, v & 0x0F])


def put_ltf8(v: int) -> bytes:
    """Shortest LTF8 form: `extra` continuation bytes hold values below
    2^(7*(extra+1)); the first byte carries `extra` leading 1-bits."""
    v &= (1 << 64) - 1
    if v < 0x80:
        return bytes([v])
    for extra in range(1, 8):
        if v < (1 << (7 * (extra + 1))):
            prefix = (0xFF << (8 - extra)) & 0xFF
            body = v.to_bytes(extra + 1, "big")
            return bytes([body[0] | prefix]) + body[1:]
    return bytes([0xFF]) + v.to_bytes(8, "big")


def put_itf8_array(vals) -> bytes:
    return put_itf8(len(vals)) + b"".join(put_itf8(v) for v in vals)


# ---------------------------------------------------------------------------
# rANS 4x8 (order 0 and 1)
# ---------------------------------------------------------------------------

_RANS_TOTFREQ = 1 << 12


def _rans_read_freqs0(br: ByteReader):
    freqs = np.zeros(256, np.int64)
    sym = br.byte()
    last = sym
    rle = 0
    while True:
        freqs[sym] = br.itf8()
        if rle > 0:
            rle -= 1
            sym += 1
        else:
            sym = br.byte()
            if sym == last + 1:
                rle = br.byte()
            last = sym
        if sym == 0:
            break
    # A trailing 0 symbol terminates; freq[0] may still be set when the
    # stream contains byte 0: handled because loop reads freq BEFORE next.
    return freqs


def _rans_decode_0(br: ByteReader, out_size: int) -> bytes:
    freqs = _rans_read_freqs0(br)
    cum = np.zeros(257, np.int64)
    np.cumsum(freqs, out=cum[1:])
    # symbol lookup table over 4096 slots
    slots = np.zeros(_RANS_TOTFREQ, np.uint8)
    for s in np.nonzero(freqs)[0]:
        slots[cum[s]:cum[s + 1]] = s
    states = list(struct.unpack("<4I", br.read(16)))
    out = bytearray(out_size)
    data = br.data
    pos = br.pos
    for i in range(out_size):
        j = i & 3
        x = states[j]
        slot = x & (_RANS_TOTFREQ - 1)
        s = slots[slot]
        out[i] = s
        x = int(freqs[s]) * (x >> 12) + slot - int(cum[s])
        while x < (1 << 23):
            x = (x << 8) | data[pos]
            pos += 1
        states[j] = x
    br.pos = pos
    return bytes(out)


def _rans_decode_1(br: ByteReader, out_size: int) -> bytes:
    # Order-1: per-context frequency tables.
    freqs = np.zeros((256, 256), np.int64)
    ctx = br.byte()
    last_ctx = ctx
    rle_ctx = 0
    while True:
        # read order-0 style table for this context
        sym = br.byte()
        last = sym
        rle = 0
        while True:
            freqs[ctx, sym] = br.itf8()
            if rle > 0:
                rle -= 1
                sym += 1
            else:
                sym = br.byte()
                if sym == last + 1:
                    rle = br.byte()
                last = sym
            if sym == 0:
                break
        if rle_ctx > 0:
            rle_ctx -= 1
            ctx += 1
        else:
            ctx = br.byte()
            if ctx == last_ctx + 1:
                rle_ctx = br.byte()
            last_ctx = ctx
        if ctx == 0:
            break
    cum = np.zeros((256, 257), np.int64)
    np.cumsum(freqs, axis=1, out=cum[:, 1:])
    slots = np.zeros((256, _RANS_TOTFREQ), np.uint8)
    for c in range(256):
        nz = np.nonzero(freqs[c])[0]
        for s in nz:
            slots[c, cum[c, s]:cum[c, s + 1]] = s
    states = list(struct.unpack("<4I", br.read(16)))
    out = bytearray(out_size)
    data = br.data
    pos = br.pos
    quarter = out_size >> 2
    ctxs = [0, 0, 0, 0]
    ends = [quarter, 2 * quarter, 3 * quarter, out_size]
    starts = [0, quarter, 2 * quarter, 3 * quarter]
    idx = list(starts)
    # interleaved decoding: stream j decodes positions starts[j]..ends[j]
    for _ in range(quarter):
        for j in range(4):
            x = states[j]
            c = ctxs[j]
            slot = x & (_RANS_TOTFREQ - 1)
            s = slots[c, slot]
            out[idx[j]] = s
            idx[j] += 1
            x = int(freqs[c, s]) * (x >> 12) + slot - int(cum[c, s])
            while x < (1 << 23) and pos < len(data):
                x = (x << 8) | data[pos]
                pos += 1
            states[j] = x
            ctxs[j] = s
    # stream 3 handles the remainder
    j = 3
    while idx[j] < out_size:
        x = states[j]
        c = ctxs[j]
        slot = x & (_RANS_TOTFREQ - 1)
        s = slots[c, slot]
        out[idx[j]] = s
        idx[j] += 1
        x = int(freqs[c, s]) * (x >> 12) + slot - int(cum[c, s])
        while x < (1 << 23):
            x = (x << 8) | data[pos]
            pos += 1
        states[j] = x
        ctxs[j] = s
    br.pos = pos
    return bytes(out)


def rans4x8_decode(blob: bytes) -> bytes:
    br = ByteReader(blob)
    order = br.byte()
    _comp_size = struct.unpack("<I", br.read(4))[0]
    raw_size = struct.unpack("<I", br.read(4))[0]
    if order == 0:
        return _rans_decode_0(br, raw_size)
    if order == 1:
        return _rans_decode_1(br, raw_size)
    raise ValueError(f"CRAM: unsupported rANS order {order}")


def rans4x8_encode_0(raw: bytes) -> bytes:
    """Order-0 rANS 4x8 encoder (for tests and the writer's qual blocks)."""
    if not raw:
        return bytes([0]) + struct.pack("<II", 0, 0)
    hist = np.bincount(np.frombuffer(raw, np.uint8), minlength=256)
    total = hist.sum()
    freqs = (hist * _RANS_TOTFREQ // total).astype(np.int64)
    freqs[(hist > 0) & (freqs == 0)] = 1
    # fix rounding so sum == 4096
    diff = _RANS_TOTFREQ - freqs.sum()
    fmax = int(np.argmax(freqs))
    freqs[fmax] += diff
    assert freqs[fmax] > 0
    cum = np.zeros(257, np.int64)
    np.cumsum(freqs, out=cum[1:])

    # Serialize the frequency table (spec §13.4): symbols ascending; a
    # consecutive group s..s+g-1 is written as
    #   byte(s) freq(s) byte(s+1) byte(g-2) freq(s+1) ... freq(s+g-1)
    # (the decoder reads an RLE byte whenever a symbol byte equals the
    # previously read symbol byte + 1), terminated by byte 0.
    tbl = _rans_freq_table_bytes(freqs)

    # encode in 4 interleaved streams, back to front
    RANS_LOW = 1 << 23
    states = [RANS_LOW] * 4
    out_rev = bytearray()
    n = len(raw)
    for i in range(n - 1, -1, -1):
        j = i & 3
        s = raw[i]
        f = int(freqs[s])
        c = int(cum[s])
        x = states[j]
        x_max = ((RANS_LOW >> 12) << 8) * f
        while x >= x_max:
            out_rev.append(x & 0xFF)
            x >>= 8
        states[j] = ((x // f) << 12) + (x % f) + c
    body = struct.pack("<4I", *states) + bytes(reversed(out_rev))
    payload = bytes(tbl) + body
    return bytes([0]) + struct.pack("<II", len(payload), n) + payload


def _rans_norm_freqs(hist: np.ndarray) -> np.ndarray:
    total = hist.sum()
    freqs = (hist * _RANS_TOTFREQ // max(total, 1)).astype(np.int64)
    freqs[(hist > 0) & (freqs == 0)] = 1
    diff = _RANS_TOTFREQ - freqs.sum()
    freqs[int(np.argmax(freqs))] += diff
    return freqs


def _rans_freq_table_bytes(freqs: np.ndarray) -> bytes:
    """Symbol/frequency serialization shared by order-0 tables and each
    order-1 context row (spec §13.4; see rans4x8_encode_0)."""
    tbl = bytearray()
    syms = [int(x) for x in np.nonzero(freqs)[0]]
    i = 0
    while i < len(syms):
        g = 1
        while i + g < len(syms) and syms[i + g] == syms[i] + g:
            g += 1
        s0 = syms[i]
        tbl.append(s0)
        tbl += put_itf8(int(freqs[s0]))
        if g > 1:
            tbl.append(s0 + 1)
            tbl.append(g - 2)
            for r in range(1, g):
                tbl += put_itf8(int(freqs[s0 + r]))
        i += g
    tbl.append(0)
    return bytes(tbl)


def rans4x8_encode_1(raw: bytes) -> bytes:
    """Order-1 rANS 4x8 encoder (tests the order-1 decoder; quarters are
    encoded independently, context = previous byte, 0 at quarter start)."""
    n = len(raw)
    if n < 4:
        return rans4x8_encode_0(raw)
    quarter = n >> 2
    starts = [0, quarter, 2 * quarter, 3 * quarter]
    ends = [quarter, 2 * quarter, 3 * quarter, n]
    hist = np.zeros((256, 256), np.int64)
    for j in range(4):
        ctx = 0
        for i in range(starts[j], ends[j]):
            hist[ctx, raw[i]] += 1
            ctx = raw[i]
    freqs = np.zeros((256, 256), np.int64)
    cum = np.zeros((256, 257), np.int64)
    used_ctx = np.nonzero(hist.sum(axis=1))[0]
    for c in used_ctx:
        freqs[c] = _rans_norm_freqs(hist[c])
        np.cumsum(freqs[c], out=cum[c, 1:])

    # Context-table serialization mirrors the order-0 table nesting.
    tbl = bytearray()
    ctxs = [int(c) for c in used_ctx]
    i = 0
    while i < len(ctxs):
        g = 1
        while i + g < len(ctxs) and ctxs[i + g] == ctxs[i] + g:
            g += 1
        c0 = ctxs[i]
        tbl.append(c0)
        tbl += _rans_freq_table_bytes(freqs[c0])
        if g > 1:
            tbl.append(c0 + 1)
            tbl.append(g - 2)
            for r in range(1, g):
                tbl += _rans_freq_table_bytes(freqs[c0 + r])
        i += g
    tbl.append(0)

    RANS_LOW = 1 << 23
    states = [RANS_LOW] * 4
    out_rev = bytearray()
    # Interleave renormalization bytes exactly inversely to the decoder's
    # round-robin (position-major, streams j = 3..0 within a step).
    max_len = max(ends[j] - starts[j] for j in range(4))
    for step in range(max_len - 1, -1, -1):
        for j in range(3, -1, -1):
            pos = starts[j] + step
            if pos >= ends[j]:
                continue
            sym = raw[pos]
            ctx = raw[pos - 1] if pos > starts[j] else 0
            f = int(freqs[ctx, sym])
            c = int(cum[ctx, sym])
            x = states[j]
            x_max = ((RANS_LOW >> 12) << 8) * f
            while x >= x_max:
                out_rev.append(x & 0xFF)
                x >>= 8
            states[j] = ((x // f) << 12) + (x % f) + c
    payload = bytes(tbl) + struct.pack("<4I", *states) + bytes(reversed(out_rev))
    return bytes([1]) + struct.pack("<II", len(payload), n) + payload


def _decompress(method: int, blob: bytes, raw_size: int) -> bytes:
    if method == M_RAW:
        return blob
    if method == M_GZIP:
        return gzip.decompress(blob)
    if method == M_BZIP2:
        return bz2.decompress(blob)
    if method == M_LZMA:
        return lzma.decompress(blob)
    if method == M_RANS4x8:
        return rans4x8_decode(blob)
    names = {M_RANSNx16: "rANS Nx16", M_ARITH: "adaptive arithmetic",
             M_FQZ: "fqzcomp", M_TOK3: "name tokeniser"}
    raise ValueError(f"CRAM: block codec {names.get(method, method)} "
                     f"(CRAM 3.1) is not supported; re-encode with "
                     f"`samtools view -O cram,version=3.0`")


# ---------------------------------------------------------------------------
# Bit reader for CORE blocks (MSB first)
# ---------------------------------------------------------------------------

class BitReader:
    __slots__ = ("data", "pos", "bit")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.bit = 0

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos]
            v = (v << 1) | ((byte >> (7 - self.bit)) & 1)
            self.bit += 1
            if self.bit == 8:
                self.bit = 0
                self.pos += 1
        return v


# ---------------------------------------------------------------------------
# Codecs
# ---------------------------------------------------------------------------

class Codec:
    """Decodes one data series.  `read_int(core, ext)` / `read_bytes`."""

    def __init__(self, codec_id: int, params: bytes):
        self.id = codec_id
        br = ByteReader(params)
        if codec_id == 0:                       # NULL
            pass
        elif codec_id == 1:                     # EXTERNAL
            self.content_id = br.itf8()
        elif codec_id == 3:                     # HUFFMAN
            self.alphabet = br.itf8_array()
            self.lengths = br.itf8_array()
            if len(self.alphabet) == 1 and self.lengths[0] == 0:
                self.const = self.alphabet[0]
            else:
                self._build_huffman()
        elif codec_id == 4:                     # BYTE_ARRAY_LEN
            len_id = br.itf8()
            len_params = br.read(br.itf8())
            val_id = br.itf8()
            val_params = br.read(br.itf8())
            self.len_codec = Codec(len_id, len_params)
            self.val_codec = Codec(val_id, val_params)
        elif codec_id == 5:                     # BYTE_ARRAY_STOP
            self.stop = br.byte()
            self.content_id = br.itf8()
        elif codec_id == 6:                     # BETA
            self.offset = br.itf8()
            self.n_bits = br.itf8()
        else:
            raise ValueError(f"CRAM: codec {codec_id} not supported")

    def _build_huffman(self):
        # canonical codes: sort by (length, symbol)
        pairs = sorted(zip(self.lengths, self.alphabet))
        code = 0
        prev_len = pairs[0][0]
        table = {}
        for ln, sym in pairs:
            code <<= (ln - prev_len)
            prev_len = ln
            table[(ln, code)] = sym
            code += 1
        self.huff_table = table
        self.max_len = max(self.lengths)

    def read_int(self, core: BitReader, ext: dict) -> int:
        if self.id == 1:
            return ext[self.content_id].itf8()
        if self.id == 3:
            if hasattr(self, "const"):
                return self.const
            code = 0
            for ln in range(1, self.max_len + 1):
                code = (code << 1) | core.read_bits(1)
                sym = self.huff_table.get((ln, code))
                if sym is not None:
                    return sym
            raise ValueError("CRAM: bad huffman code")
        if self.id == 6:
            return core.read_bits(self.n_bits) - self.offset
        raise ValueError(f"CRAM: codec {self.id} cannot read ints")

    def read_byte(self, core: BitReader, ext: dict) -> int:
        if self.id == 1:
            return ext[self.content_id].byte()
        return self.read_int(core, ext)

    def read_bytes(self, core: BitReader, ext: dict, n: int = -1) -> bytes:
        if self.id == 4:                        # BYTE_ARRAY_LEN
            ln = self.len_codec.read_int(core, ext)
            vr = self.val_codec
            if vr.id == 1:
                return ext[vr.content_id].read(ln)
            return bytes(vr.read_byte(core, ext) for _ in range(ln))
        if self.id == 5:                        # BYTE_ARRAY_STOP
            r = ext[self.content_id]
            end = r.data.index(self.stop, r.pos)
            b = r.data[r.pos:end]
            r.pos = end + 1
            return b
        if self.id == 1:
            return ext[self.content_id].read(n)
        return bytes(self.read_byte(core, ext) for _ in range(n))


# ---------------------------------------------------------------------------
# Container / block structures
# ---------------------------------------------------------------------------

@dataclass
class Block:
    method: int
    content_type: int
    content_id: int
    data: bytes                                 # decompressed


def _read_block(br: ByteReader) -> Block:
    method = br.byte()
    ctype = br.byte()
    cid = br.itf8()
    comp_size = br.itf8()
    raw_size = br.itf8()
    blob = br.read(comp_size)
    br.read(4)                                  # CRC32
    return Block(method, ctype, cid, _decompress(method, blob, raw_size))


def _write_block(method: int, ctype: int, cid: int, raw: bytes) -> bytes:
    if method == M_GZIP:
        blob = gzip.compress(raw, 4)
    elif method == M_RANS4x8:
        blob = rans4x8_encode_0(raw)
    else:
        method = M_RAW
        blob = raw
    head = bytes([method, ctype]) + put_itf8(cid) + put_itf8(len(blob)) \
        + put_itf8(len(raw))
    body = head + blob
    return body + struct.pack("<I", zlib.crc32(body))


@dataclass
class ContainerHeader:
    length: int
    ref_seq_id: int
    start: int
    span: int
    n_records: int
    record_counter: int
    n_bases: int
    n_blocks: int
    landmarks: list


def _read_container_header(fh) -> ContainerHeader | None:
    head = fh.read(4)
    if len(head) < 4:
        return None
    (length,) = struct.unpack("<i", head)
    # Read a generous chunk for the ITF8 fields (max 5+5+5+5+9+9+5 + array).
    buf = fh.read(64 * 1024)
    br = ByteReader(buf)
    ref_id = br.itf8()
    start = br.itf8()
    span = br.itf8()
    n_rec = br.itf8()
    counter = br.ltf8()
    bases = br.ltf8()
    n_blocks = br.itf8()
    landmarks = br.itf8_array()
    br.read(4)                                  # CRC32
    fh.seek(br.pos - len(buf), 1)
    return ContainerHeader(length, ref_id, start, span, n_rec, counter,
                           bases, n_blocks, landmarks)


def _container_header_bytes(ref_id, start, span, n_rec, counter, bases,
                            blocks: list[bytes],
                            landmark_ixs=None) -> bytes:
    landmarks = []
    off = 0
    for i, b in enumerate(blocks):
        if landmark_ixs is None or i in landmark_ixs:
            landmarks.append(off)
        off += len(b)
    body = b"".join(blocks)
    head = (put_itf8(ref_id) + put_itf8(start) + put_itf8(span)
            + put_itf8(n_rec) + put_ltf8(counter) + put_ltf8(bases)
            + put_itf8(len(blocks)) + put_itf8(len(landmarks))
            + b"".join(put_itf8(v) for v in landmarks))
    head_full = struct.pack("<i", len(body)) + head
    head_full += struct.pack("<I", zlib.crc32(head_full))
    return head_full + body


def _eof_container() -> bytes:
    """CRAM v3 EOF sentinel: a container with ref_seq_id -1, start 4542278,
    zero records, holding one empty compression-header block (spec §9)."""
    blk = _write_block(M_RAW, CT_COMPRESSION_HEADER, 0, put_itf8(0) * 6)
    return _container_header_bytes(-1, 4542278, 0, 0, 0, 0, [blk])


_EOF_START = 4542278


# ---------------------------------------------------------------------------
# Compression header
# ---------------------------------------------------------------------------

@dataclass
class CompressionHeader:
    read_names: bool = True
    ap_delta: bool = True
    reference_required: bool = True
    sub_matrix: bytes = b"\x1b" * 5
    tag_dict: list = field(default_factory=lambda: [[]])
    series: dict = field(default_factory=dict)     # "BF" -> Codec
    tags: dict = field(default_factory=dict)       # int key -> Codec


def _parse_compression_header(data: bytes) -> CompressionHeader:
    br = ByteReader(data)
    ch = CompressionHeader()
    # --- preservation map
    br.itf8()                                   # size in bytes
    n = br.itf8()
    for _ in range(n):
        key = br.read(2)
        if key == b"RN":
            ch.read_names = bool(br.byte())
        elif key == b"AP":
            ch.ap_delta = bool(br.byte())
        elif key == b"RR":
            ch.reference_required = bool(br.byte())
        elif key == b"SM":
            ch.sub_matrix = br.read(5)
        elif key == b"TD":
            ln = br.itf8()
            blob = br.read(ln)
            ch.tag_dict = []
            for entry in blob.split(b"\x00")[:-1] if blob.endswith(b"\x00") \
                    else blob.split(b"\x00"):
                triplets = [entry[i:i + 3] for i in range(0, len(entry), 3)]
                ch.tag_dict.append(triplets)
            if not ch.tag_dict:
                ch.tag_dict = [[]]
        else:
            raise ValueError(f"CRAM: unknown preservation key {key!r}")
    # --- data series encodings
    br.itf8()
    n = br.itf8()
    for _ in range(n):
        key = br.read(2).decode()
        codec_id = br.itf8()
        params = br.read(br.itf8())
        ch.series[key] = Codec(codec_id, params)
    # --- tag encodings
    br.itf8()
    n = br.itf8()
    for _ in range(n):
        key = br.itf8()
        codec_id = br.itf8()
        params = br.read(br.itf8())
        ch.tags[key] = Codec(codec_id, params)
    return ch


# ---------------------------------------------------------------------------
# Record + slice decoding
# ---------------------------------------------------------------------------

@dataclass
class CramRecord:
    """Decoded CRAM record, API-compatible with bam.BamRecord.

    end: 0-based exclusive alignment end on the reference (pos +
    reference-consumed length), -1 for unmapped — used by the CRAI
    fetch path to filter records by region overlap."""
    name: str
    flag: int
    seq: np.ndarray
    qual: np.ndarray | None
    ref_id: int
    pos: int
    mapq: int
    end: int = -1

    @property
    def is_paired(self) -> bool:
        return bool(self.flag & FLAG_PAIRED)

    @property
    def mate_ix(self) -> int:
        return 1 if (self.flag & FLAG_READ2) else 0

    def to_read(self) -> Read:
        return Read(self.name, self.seq, self.qual)


def _decode_substitution(sub_matrix: bytes, ref_code: int, bs: int) -> int:
    """ref base index (ACGTN) + 2-bit BS code -> substituted base index.
    Each matrix byte ranks the 4 alternative bases (spec §10.6)."""
    byte = sub_matrix[ref_code if ref_code < 5 else 4]
    alts = [b for b in range(5) if b != (ref_code if ref_code < 5 else 4)]
    for rank, alt in enumerate(alts):
        if ((byte >> (6 - 2 * rank)) & 3) == bs:
            return alt
    return 4


def _encode_substitution(sub_matrix: bytes, ref_code: int,
                         alt_code: int) -> int:
    """Inverse of _decode_substitution: BS code placing `alt_code` as the
    substituted base over `ref_code`."""
    rc = ref_code if ref_code < 5 else 4
    alts = [b for b in range(5) if b != rc]
    rank = alts.index(alt_code if alt_code < 5 else 4)
    return (sub_matrix[rc] >> (6 - 2 * rank)) & 3


def diff_features(seq: np.ndarray, refc: np.ndarray, pos: int,
                  sub_matrix: bytes = b"\x1b" * 5) -> list:
    """CRAM feature list storing `seq` against the reference slice at
    `pos` as X substitutions (overhang past the contig end becomes a soft
    clip) — lets CramWriter preserve actual read bases for mapped records
    instead of silently reconstructing the reference."""
    matched = max(min(int(seq.size), int(refc.size) - int(pos)), 0)
    feats = []
    ref_slice = refc[pos:pos + matched]
    for i in np.nonzero(seq[:matched] != ref_slice)[0]:
        feats.append(("X", int(i),
                      _encode_substitution(sub_matrix, int(ref_slice[i]),
                                           int(seq[i]))))
    if matched < seq.size:
        feats.append(("S", matched, seq[matched:]))
    return feats


def _decode_slice(ch: CompressionHeader, slice_blocks: list[Block],
                  container_ref_id: int, ref_getter, counter_base: int):
    sh_block = slice_blocks[0]
    br = ByteReader(sh_block.data)
    s_ref_id = br.itf8()
    s_start = br.itf8()
    _span = br.itf8()
    n_records = br.itf8()
    _counter = br.ltf8()
    _n_blocks = br.itf8()
    _content_ids = br.itf8_array()
    embedded_ref_id = br.itf8()
    br.read(16)                                 # MD5

    core = None
    ext = {}
    for b in slice_blocks[1:]:
        if b.content_type == CT_CORE:
            core = BitReader(b.data)
        elif b.content_type == CT_EXTERNAL:
            ext[b.content_id] = ByteReader(b.data)

    embedded_ref = None
    if embedded_ref_id >= 0 and embedded_ref_id in ext:
        embedded_ref = dna.encode(ext[embedded_ref_id].data.decode())

    S = ch.series

    def rint(key, default=None):
        c = S.get(key)
        if c is None:
            if default is not None:
                return default
            raise ValueError(f"CRAM: series {key} missing")
        return c.read_int(core, ext)

    def rbyte(key):
        return S[key].read_byte(core, ext)

    def rbytes(key, n=-1):
        return S[key].read_bytes(core, ext, n)

    records = []
    last_ap = s_start
    for i in range(n_records):
        bf = rint("BF")
        cf = rint("CF")
        ref_id = rint("RI") if container_ref_id == -2 else s_ref_id
        rl = rint("RL")
        ap = rint("AP")
        if ch.ap_delta:
            ap = last_ap + ap
            last_ap = ap
        _rg = rint("RG", default=-1) if "RG" in S else -1
        if ch.read_names:
            name = rbytes("RN").decode()
        else:
            name = f"cram.{counter_base + i}"
        if cf & CF_DETACHED:
            mf = rint("MF")
            if not ch.read_names:
                name = rbytes("RN").decode()
            _ns = rint("NS")
            _np_ = rint("NP")
            _ts = rint("TS")
            if mf & 1:
                bf |= FLAG_MATE_REVERSE
            if mf & 2:
                bf |= FLAG_MATE_UNMAPPED
        elif cf & CF_HAS_MATE_DOWNSTREAM:
            _nf = rint("NF")
        tl = rint("TL", default=0) if "TL" in S else 0
        for tag_key in ch.tag_dict[tl] if tl < len(ch.tag_dict) else []:
            key_int = (tag_key[0] << 16) | (tag_key[1] << 8) | tag_key[2]
            ch.tags[key_int].read_bytes(core, ext)

        qual = None
        if not (bf & FLAG_UNMAPPED):
            fn = rint("FN")
            # reference slice for reconstruction
            seq = np.full(rl, 4, np.int8)
            if embedded_ref is not None:
                refc = embedded_ref
                ref_off = s_start
            elif ref_getter is not None and ref_id >= 0:
                refc = ref_getter(ref_id)
                ref_off = 1                     # 1-based AP
            else:
                refc = None
                ref_off = 1
            fpos = 0                            # 0-based in read
            rpos = ap                           # 1-based on ref
            out = []

            def emit_ref(upto):
                nonlocal fpos, rpos
                n = upto - fpos
                if n <= 0:
                    return
                if refc is not None:
                    lo = rpos - ref_off
                    chunk = refc[lo:lo + n]
                    if chunk.size < n:
                        chunk = np.concatenate(
                            [chunk, np.full(n - chunk.size, 4, np.int8)])
                else:
                    chunk = np.full(n, 4, np.int8)
                out.append(chunk.astype(np.int8))
                fpos += n
                rpos += n

            quals_sparse = {}
            prev_fp = 0
            for _f in range(fn):
                fc = chr(rint("FC"))
                fp = rint("FP") + prev_fp
                prev_fp = fp
                emit_ref(fp - 1)
                if fc == "X":
                    bs = rint("BS")
                    rbase = refc[rpos - ref_off] if refc is not None else 4
                    out.append(np.array(
                        [_decode_substitution(ch.sub_matrix, int(rbase), bs)],
                        np.int8))
                    fpos += 1
                    rpos += 1
                elif fc == "I":
                    ins = rbytes("IN")
                    out.append(dna.encode(ins.decode()))
                    fpos += len(ins)
                elif fc == "i":
                    b = rbyte("BA")
                    out.append(dna.encode(chr(b)))
                    fpos += 1
                elif fc == "D":
                    rpos += rint("DL")
                elif fc == "S":
                    sc = rbytes("SC")
                    out.append(dna.encode(sc.decode()))
                    fpos += len(sc)
                elif fc == "N":
                    rpos += rint("RS")
                elif fc == "P":
                    rint("PD")
                elif fc == "H":
                    rint("HC")
                elif fc == "B":
                    b = rbyte("BA")
                    quals_sparse[fpos] = rbyte("QS")
                    out.append(dna.encode(chr(b)))
                    fpos += 1
                    rpos += 1
                elif fc == "Q":
                    quals_sparse[fpos] = rbyte("QS")
                elif fc == "b":
                    bb = rbytes("BB")
                    out.append(dna.encode(bb.decode()))
                    fpos += len(bb)
                    rpos += len(bb)
                elif fc == "q":
                    qq = rbytes("QQ", 0)
                    for qi, qv in enumerate(qq):
                        quals_sparse[fpos + qi] = qv
                else:
                    raise ValueError(f"CRAM: unknown feature code {fc!r}")
            emit_ref(rl)
            seq = np.concatenate(out)[:rl] if out else np.empty(0, np.int8)
            mapq = rint("MQ")
            if cf & CF_QUALS:
                qual = np.frombuffer(rbytes("QS", rl), np.uint8).copy()
            elif quals_sparse:
                qual = np.full(rl, 0xFF, np.uint8)
                for p, v in quals_sparse.items():
                    qual[p] = v
        else:
            mapq = 0
            if cf & CF_UNKNOWN_BASES:
                seq = np.full(rl, 4, np.int8)
            else:
                seq = np.frombuffer(rbytes("BA", rl), np.uint8)
                seq = dna.encode(seq.tobytes().decode())
            if cf & CF_QUALS:
                qual = np.frombuffer(rbytes("QS", rl), np.uint8).copy()

        if bf & FLAG_REVERSE:
            seq = dna.revcomp(seq)
            if qual is not None:
                qual = qual[::-1].copy()
        if bf & FLAG_UNMAPPED:
            pos0, end0 = -1, -1
        else:
            pos0 = ap - 1
            # rpos ended 1-based one-past the last ref base consumed.
            end0 = max(rpos - 1, pos0 + 1)
        records.append(CramRecord(name, bf, seq, qual, ref_id, pos0, mapq,
                                  end0))
    return records


# ---------------------------------------------------------------------------
# Public reader
# ---------------------------------------------------------------------------

SKIP_MASK = 0x100 | 0x200 | 0x400 | 0x800      # secondary/qcfail/dup/suppl


class CramFile:
    """Seekable CRAM 3.x reader: parses the file definition and SAM-header
    container once, then decodes data containers either sequentially or
    from explicit file offsets (the CRAI fetch path, seq/crai.py).  The
    reference reads indexed CRAM through htslib (fastx.rs:586-887)."""

    def __init__(self, path, reference=None):
        self.path = str(path)
        ref_map = None
        if isinstance(reference, (str, Path)):
            from . import fastx as _fastx
            ref_map = dict(_fastx.read_fasta(str(reference)))
        elif isinstance(reference, dict):
            ref_map = reference
        self._ref_map = ref_map

        self._fh = open(self.path, "rb")
        head = self._fh.read(26)
        if len(head) < 26 or head[:4] != CRAM_MAGIC:
            raise ValueError(f"{path}: not a CRAM file (bad/truncated "
                             "file definition)")
        major = head[4]
        if major not in (2, 3):
            raise ValueError(f"{path}: CRAM major version {major} "
                             "not supported")
        # SAM header container: extract @SQ names/lengths for ref lookup.
        hdr = _read_container_header(self._fh)
        if hdr is None:
            raise ValueError(f"{path}: missing SAM header container")
        body = self._fh.read(hdr.length)
        br = ByteReader(body)
        block = _read_block(br)
        self.ref_names: list[str] = []
        self.ref_lens: list[int] = []
        raw = block.data
        if len(raw) >= 4:
            (l_text,) = struct.unpack("<i", raw[:4])
            text = raw[4:4 + l_text].decode(errors="replace")
            for line in text.splitlines():
                if line.startswith("@SQ"):
                    name, ln = None, 0
                    for fld in line.split("\t"):
                        if fld.startswith("SN:"):
                            name = fld[3:]
                        elif fld.startswith("LN:"):
                            ln = int(fld[3:])
                    if name is not None:
                        self.ref_names.append(name)
                        self.ref_lens.append(ln)
        self.data_start = self._fh.tell()

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def containers(self, offset: int | None = None):
        """Yields (file_offset, ContainerHeader) for data containers,
        starting at `offset` (default: first data container), WITHOUT
        decoding bodies (used by crai.build_crai)."""
        self._fh.seek(self.data_start if offset is None else offset)
        while True:
            off = self._fh.tell()
            hdr = _read_container_header(self._fh)
            if hdr is None:
                return
            if hdr.ref_seq_id == -1 and hdr.start == _EOF_START and \
                    hdr.n_records == 0:
                return                          # EOF container
            yield off, hdr
            self._fh.seek(off)
            _read_container_header(self._fh)
            self._fh.seek(hdr.length, 1)

    def container_records(self, offset: int) -> list[CramRecord]:
        """Decodes ALL records of the container at `offset` (no flag
        filtering — fetch callers filter by region + flags)."""
        self._fh.seek(offset)
        hdr = _read_container_header(self._fh)
        if hdr is None or (hdr.ref_seq_id == -1 and hdr.start == _EOF_START
                           and hdr.n_records == 0):
            return []
        body = self._fh.read(hdr.length)
        br = ByteReader(body)
        blocks = []
        while br.pos < len(body):
            blocks.append(_read_block(br))
        ch = _parse_compression_header(blocks[0].data)

        def ref_getter(rid):
            if rid < 0 or rid >= len(self.ref_names):
                return None
            if self._ref_map is None:
                if ch.reference_required:
                    raise ValueError(
                        f"{self.path}: reference-based CRAM needs "
                        "--reference (the FASTA it was encoded against)")
                return None
            return self._ref_map.get(self.ref_names[rid])

        out = []
        counter = hdr.record_counter
        i = 1
        while i < len(blocks):
            if blocks[i].content_type != CT_SLICE_HEADER:
                i += 1
                continue
            j = i + 1
            while j < len(blocks) and blocks[j].content_type in \
                    (CT_CORE, CT_EXTERNAL):
                j += 1
            recs = _decode_slice(ch, blocks[i:j], hdr.ref_seq_id,
                                 ref_getter, counter)
            counter += len(recs)
            out.extend(recs)
            i = j
        return out

    def records(self, keep_flags: int = SKIP_MASK):
        """Yields every record of the file in order, skipping flags in
        `keep_flags` (sequential full-scan path)."""
        for off, _hdr in self.containers():
            for r in self.container_records(off):
                if not (r.flag & keep_flags):
                    yield r


def read_cram_records(path, reference=None, keep_flags: int = SKIP_MASK):
    """Yields CramRecord for every primary record of a CRAM 3.x file.

    reference: None, a dict {contig_name: codes}, or a FASTA path — needed
    for reference-based slices (RR=true), like `samtools view -T`.
    Counterpart of the reference's htslib CRAM path (fastx.rs:586-620).
    """
    with CramFile(path, reference) as cf:
        yield from cf.records(keep_flags)


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

class CramWriter:
    """Minimal spec-compliant CRAM 3.0 writer: one slice per container,
    EXTERNAL encodings for every series, gzip blocks.  Mapped records are
    stored reference-based (features); unmapped records store bases.

    Used by tests for round-trips; not performance-tuned.
    """

    # external block content ids per series
    _IDS = {"BF": 1, "CF": 2, "RL": 3, "AP": 4, "RN": 5, "MF": 6, "NS": 7,
            "NP": 8, "TS": 9, "FN": 10, "FC": 11, "FP": 12, "BS": 13,
            "IN": 14, "DL": 15, "SC": 16, "BA": 17, "QS": 18, "MQ": 19,
            "RI": 20, "TL": 21}

    def __init__(self, path, ref_names, ref_lens, reference=None):
        self.fh = open(path, "wb")
        self.ref_names = list(ref_names)
        self.reference = reference or {}
        self.counter = 0
        self.fh.write(CRAM_MAGIC + bytes([3, 0]) + b"\x00" * 20)
        header = "@HD\tVN:1.6\n" + "".join(
            f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in zip(ref_names, ref_lens))
        raw = struct.pack("<i", len(header)) + header.encode()
        blk = _write_block(M_GZIP, CT_FILE_HEADER, 0, raw)
        self.fh.write(_container_header_bytes(-1, 0, 0, 0, 0, 0, [blk]))
        self._pending = []

    def write(self, name, flag, seq, qual=None, ref_id=-1, pos=-1, mapq=255,
              features=None):
        """features: list of ('X', read_pos0, bs_code) /
        ('I', read_pos0, codes) / ('D', read_pos0, length) /
        ('S', read_pos0, codes); or None — mapped records are then diffed
        against the reference automatically (X substitutions) so the
        stored bases always reconstruct `seq` exactly."""
        if (features is None and not (flag & FLAG_UNMAPPED) and ref_id >= 0
                and pos >= 0):
            refc = self.reference.get(self.ref_names[ref_id]) \
                if isinstance(self.reference, dict) else None
            if refc is not None:
                features = diff_features(seq, refc, pos)
        # Containers never span references on sorted input (htslib does the
        # same) — keeps every container single-ref so .crai fetch can skip
        # whole containers instead of treating them as multi-ref (-2).
        if self._pending and self._pending[-1][4] != ref_id:
            self.flush()
        self._pending.append((name, flag, seq, qual, ref_id, pos, mapq,
                              features or []))
        if len(self._pending) >= 4096:
            self.flush()

    def flush(self):
        if not self._pending:
            return
        recs = self._pending
        self._pending = []
        streams = {k: bytearray() for k in self._IDS}
        ref_ids = {r[4] for r in recs}
        container_ref = ref_ids.pop() if len(ref_ids) == 1 else -2
        multi_ref = container_ref == -2
        n_bases = 0
        starts, ends = [], []
        for _n, flag, seq, _q, _ri, pos, _mq, features in recs:
            if pos < 0 or (flag & FLAG_UNMAPPED):
                continue
            starts.append(pos)
            ref_len = seq.size
            for fc, _rp0, payload in features:
                if fc == "D":
                    ref_len += payload
                elif fc == "I" or fc == "S":
                    ref_len -= len(payload)
            ends.append(pos + max(ref_len, 1))
        s_start = (min(starts) + 1) if starts else 0
        # Span covers record ENDS, not just starts — index-driven fetch
        # (seq/crai.py) must find reads that only overlap a region's tail.
        s_span = (max(ends) - min(starts)) if starts else 0

        for name, flag, seq, qual, ref_id, pos, mapq, features in recs:
            n_bases += seq.size
            streams["BF"] += put_itf8(flag)
            cf = CF_DETACHED | (CF_QUALS if qual is not None else 0)
            streams["CF"] += put_itf8(cf)
            if multi_ref:
                streams["RI"] += put_itf8(ref_id)
            streams["RL"] += put_itf8(seq.size)
            streams["AP"] += put_itf8(pos + 1 if pos >= 0 else 0)
            streams["RN"] += name.encode() + b"\x00"
            streams["MF"] += put_itf8(0)
            streams["NS"] += put_itf8(-1)
            streams["NP"] += put_itf8(0)
            streams["TS"] += put_itf8(0)
            streams["TL"] += put_itf8(0)
            if not (flag & FLAG_UNMAPPED):
                streams["FN"] += put_itf8(len(features))
                prev_fp = 0
                for fc, rp0, payload in features:
                    fp = rp0 + 1
                    streams["FC"] += put_itf8(ord(fc))
                    streams["FP"] += put_itf8(fp - prev_fp)
                    prev_fp = fp
                    if fc == "X":
                        streams["BS"] += put_itf8(payload)
                    elif fc == "I":
                        streams["IN"] += dna.decode(payload).encode() + b"\x00"
                    elif fc == "D":
                        streams["DL"] += put_itf8(payload)
                    elif fc == "S":
                        streams["SC"] += dna.decode(payload).encode() + b"\x00"
                    else:
                        raise ValueError(f"writer: feature {fc} unsupported")
                streams["MQ"] += put_itf8(mapq)
                if qual is not None:
                    streams["QS"] += bytes(qual)
            else:
                streams["BA"] += dna.decode(seq).encode()
                if qual is not None:
                    streams["QS"] += bytes(qual)

        # --- compression header
        any_mapped = any(not (r[1] & FLAG_UNMAPPED) for r in recs)
        pres = bytearray()
        entries = [(b"RN", bytes([1])), (b"AP", bytes([0])),
                   (b"RR", bytes([1 if any_mapped else 0])),
                   (b"SM", b"\x1b" * 5),
                   (b"TD", put_itf8(1) + b"\x00")]
        pres += put_itf8(len(entries))
        for k, v in entries:
            pres += k + v
        pres_map = put_itf8(len(pres)) + bytes(pres)

        def ext_enc(key):
            params = put_itf8(self._IDS[key])
            return key.encode() + put_itf8(1) + put_itf8(len(params)) + params

        def bas_enc(key):                       # byte_array_stop
            params = bytes([0]) + put_itf8(self._IDS[key])
            return key.encode() + put_itf8(5) + put_itf8(len(params)) + params

        def bal_enc(key, n_key):
            # BYTE_ARRAY_LEN with EXTERNAL len + EXTERNAL vals (same block
            # for vals, len in its own stream) — here: len from RL is not
            # expressible, so use external len stream n_key.
            len_params = put_itf8(self._IDS[n_key])
            val_params = put_itf8(self._IDS[key])
            params = (put_itf8(1) + put_itf8(len(len_params)) + len_params
                      + put_itf8(1) + put_itf8(len(val_params)) + val_params)
            return key.encode() + put_itf8(4) + put_itf8(len(params)) + params

        series = [ext_enc(k) for k in
                  ("BF", "CF", "RL", "AP", "MF", "NS", "NP", "TS", "TL",
                   "FN", "FC", "FP", "BS", "DL", "MQ", "BA", "QS")]
        series.append(bas_enc("RN"))
        series.append(bas_enc("IN"))
        series.append(bas_enc("SC"))
        if multi_ref:
            series.append(ext_enc("RI"))
        ser_body = put_itf8(len(series)) + b"".join(series)
        ser_map = put_itf8(len(ser_body)) + ser_body
        tag_map = put_itf8(1) + put_itf8(0)
        ch_raw = pres_map + ser_map + tag_map
        ch_block = _write_block(M_GZIP, CT_COMPRESSION_HEADER, 0, ch_raw)

        # --- slice
        used = [k for k in self._IDS if streams[k]]
        sh = (put_itf8(container_ref) + put_itf8(s_start) + put_itf8(s_span)
              + put_itf8(len(recs)) + put_ltf8(self.counter)
              + put_itf8(1 + len(used))
              + put_itf8_array([self._IDS[k] for k in used])
              + put_itf8(-1) + b"\x00" * 16)
        blocks = [ch_block, _write_block(M_RAW, CT_SLICE_HEADER, 0, sh),
                  _write_block(M_RAW, CT_CORE, 0, b"")]
        for k in used:
            method = M_RANS4x8 if k == "QS" else M_GZIP
            blocks.append(_write_block(method, CT_EXTERNAL, self._IDS[k],
                                       bytes(streams[k])))
        self.fh.write(_container_header_bytes(
            container_ref, s_start, s_span, len(recs), self.counter,
            n_bases, blocks, landmark_ixs={1}))
        self.counter += len(recs)

    def close(self):
        self.flush()
        self.fh.write(_eof_container())
        self.fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

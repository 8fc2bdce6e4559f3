"""BAM input/output without htslib (counterpart of reference
seq/fastx.rs:586-887 BAM/CRAM record adapters).

The package uses no htslib/pysam, so BGZF and BAM record layout are parsed
directly: BGZF is a sequence of gzip members (RFC1952 with a BC extra
field), each ≤64 KiB uncompressed; BAM is a little-endian binary record
stream.  Only the fields the pipeline needs are extracted (name, flag,
seq, qual) — reads are restored to their original orientation (revcomp if
FLAG&16) exactly like the reference's `RecordToFastx` adapters.

CRAM requires external codecs and a reference; it is rejected with a clear
error (the reference shells out to htslib for it).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from . import dna
from .fastx import Read

FLAG_PAIRED = 0x1
FLAG_UNMAPPED = 0x4
FLAG_REVERSE = 0x10
FLAG_MATE1 = 0x40
FLAG_MATE2 = 0x80
FLAG_SECONDARY = 0x100
FLAG_QCFAIL = 0x200
FLAG_DUP = 0x400
FLAG_SUPPLEMENTARY = 0x800

_CIGAR_OPS = "MIDNSHP=X"       # BAM op codes 0..8 (SAM spec §4.2)


def pack_tag_f(tag: str, value: float) -> bytes:
    """Binary BAM float tag, e.g. pack_tag_f('XF', 0.95)."""
    return tag.encode() + b"f" + struct.pack("<f", value)
SKIP_MASK = FLAG_SECONDARY | FLAG_SUPPLEMENTARY

# BAM 4-bit seq codes: =ACMGRSVTWYHKDBN -> our int8 codes (A0 C1 G2 T3 N4).
_NT16_TO_CODE = np.full(16, 4, np.int8)
_NT16_TO_CODE[1] = 0   # A
_NT16_TO_CODE[2] = 1   # C
_NT16_TO_CODE[4] = 2   # G
_NT16_TO_CODE[8] = 3   # T
_CODE_TO_NT16 = np.array([1, 2, 4, 8, 15], np.uint8)


def bgzf_decompress_stream(path):
    """Yields decompressed chunks of a BGZF (or plain gzip) file."""
    with open(path, "rb") as f:
        data = f.read(1 << 20)
        while data:
            d = zlib.decompressobj(31)
            out = d.decompress(data)
            while not d.eof:
                more = f.read(1 << 20)
                if not more:
                    break
                out += d.decompress(more)
            if out:
                yield out
            data = d.unused_data
            if not data:
                data = f.read(1 << 20)


class _StreamBuf:
    """Byte accumulator over a chunk iterator with exact-size reads."""

    def __init__(self, chunks):
        self._chunks = iter(chunks)
        self._buf = b""
        self._pos = 0

    def read(self, n: int) -> bytes:
        while len(self._buf) - self._pos < n:
            try:
                chunk = next(self._chunks)
            except StopIteration:
                break
            self._buf = self._buf[self._pos:] + chunk
            self._pos = 0
        out = self._buf[self._pos:self._pos + n]
        self._pos += len(out)
        if self._pos > (1 << 22):
            self._buf = self._buf[self._pos:]
            self._pos = 0
        return out


class BamRecord:
    __slots__ = ("name", "flag", "seq", "qual", "ref_id", "pos", "mapq",
                 "cigar", "tags")

    def __init__(self, name, flag, seq, qual, ref_id, pos, mapq,
                 cigar=None, tags=None):
        self.name = name
        self.flag = flag
        self.seq = seq           # int8 codes, SEQUENCING orientation
        self.qual = qual
        self.ref_id = ref_id
        self.pos = pos
        self.mapq = mapq
        self.cigar = cigar       # [(op_char, length)] | None
        self.tags = tags         # raw BAM tag bytes | None

    @property
    def is_paired(self):
        return bool(self.flag & FLAG_PAIRED)

    @property
    def mate_ix(self):
        return 1 if self.flag & FLAG_MATE2 else 0

    def to_read(self) -> Read:
        return Read(self.name, self.seq, self.qual)


def read_bam_records(path, keep_flags: int = SKIP_MASK, reference=None):
    """Yields BamRecord for every record whose FLAG has no bit of
    `keep_flags` set (default: primary records only).  Sequences are
    restored to the original read orientation.  `.cram` files route to the
    owned CRAM decoder (seq/cram.py); `reference` (FASTA path or dict) is
    required for reference-based CRAM."""
    path = str(path)
    if path.endswith(".cram"):
        from .cram import read_cram_records
        yield from read_cram_records(path, reference=reference,
                                     keep_flags=keep_flags)
        return
    buf = _StreamBuf(bgzf_decompress_stream(path))
    magic = buf.read(4)
    if magic != b"BAM\x01":
        raise ValueError(f"{path}: not a BAM file (bad magic {magic!r})")
    (l_text,) = struct.unpack("<i", buf.read(4))
    buf.read(l_text)
    (n_ref,) = struct.unpack("<i", buf.read(4))
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", buf.read(4))
        buf.read(l_name + 4)
    while True:
        head = buf.read(4)
        if len(head) < 4:
            return
        (block_size,) = struct.unpack("<i", head)
        rec = buf.read(block_size)
        if len(rec) < block_size:
            raise ValueError(f"{path}: truncated BAM record")
        ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq = \
            struct.unpack("<iiBBHHHi", rec[:20])
        if flag & keep_flags:
            continue
        off = 32
        name = rec[off:off + l_read_name - 1].decode()
        off += l_read_name
        cigar = None
        if n_cigar:
            raw = np.frombuffer(rec, np.uint32, n_cigar, off)
            cigar = [(_CIGAR_OPS[int(c) & 0xF], int(c) >> 4) for c in raw]
        off += 4 * n_cigar
        packed = np.frombuffer(rec, np.uint8, (l_seq + 1) // 2, off)
        codes = np.empty(l_seq, np.int8)
        codes[0::2] = _NT16_TO_CODE[packed >> 4]
        if l_seq > 1:
            codes[1::2] = _NT16_TO_CODE[packed[:(l_seq // 2)] & 0xF]
        off += (l_seq + 1) // 2
        qual = np.frombuffer(rec, np.uint8, l_seq, off).copy()
        off += l_seq
        tags = rec[off:] or None
        if qual.size and qual[0] == 0xFF:
            qual = None
        if flag & FLAG_REVERSE:
            codes = dna.revcomp(codes)
            if qual is not None:
                qual = qual[::-1].copy()
        yield BamRecord(name, flag, codes, qual, ref_id, pos, mapq,
                        cigar, tags)


def read_bam(path, reference=None):
    """Yields fastx.Read for each primary record (single-end view)."""
    for rec in read_bam_records(path, reference=reference):
        yield rec.to_read()


def read_bam_pairs(path, max_pending: int = 4_000_000, reference=None):
    """Yields (Read, Read) mate pairs from one BAM, matching by name
    (the reference's pair-matching BAM reader, fastx.rs:700-887).
    Unpaired-flag records are skipped; orphans are dropped at the end."""
    pending: dict[str, BamRecord] = {}
    for rec in read_bam_records(path, reference=reference):
        if not rec.is_paired:
            continue
        other = pending.pop(rec.name, None)
        if other is None:
            if len(pending) >= max_pending:
                raise ValueError(
                    f"{path}: over {max_pending} unmatched mates; is this "
                    "file paired?")
            pending[rec.name] = rec
            continue
        if other.mate_ix == rec.mate_ix:
            raise ValueError(f"{path}: read {rec.name} has duplicate mate "
                             f"{rec.mate_ix + 1} records")
        r1, r2 = (rec, other) if rec.mate_ix == 0 else (other, rec)
        yield r1.to_read(), r2.to_read()


def is_bam(path) -> bool:
    return str(path).endswith(".bam")


def is_paired_bam(path, reference=None) -> bool:
    """Peeks the first primary record's FLAG (how the reference decides
    between its paired and single BAM readers)."""
    for rec in read_bam_records(path, reference=reference):
        return rec.is_paired
    return False


# ---------------------------------------------------------------------------
# Minimal BAM writer (tests and tooling; the reference writes BAM via
# htslib).  One BGZF block per ~60 KiB; standard EOF marker appended.
# ---------------------------------------------------------------------------

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def _bgzf_block(payload: bytes) -> bytes:
    comp = zlib.compressobj(6, zlib.DEFLATED, -15)
    body = comp.compress(payload) + comp.flush()
    bsize = len(body) + 25 + 1
    head = (b"\x1f\x8b\x08\x04" + b"\x00" * 6 +
            struct.pack("<HccH H", 6, b"B", b"C", 2, bsize - 1))
    tail = struct.pack("<II", zlib.crc32(payload), len(payload))
    return head + body + tail


class BgzfWriter:
    """Generic BGZF text/bytes writer (tabix/bcftools-compatible .gz)."""

    def __init__(self, path):
        self._f = open(path, "wb")
        self._buf = bytearray()

    def write(self, data) -> None:
        self._buf += data.encode() if isinstance(data, str) else data
        while len(self._buf) >= 60000:
            self._f.write(_bgzf_block(bytes(self._buf[:60000])))
            del self._buf[:60000]

    def close(self) -> None:
        if self._buf:
            self._f.write(_bgzf_block(bytes(self._buf)))
            self._buf.clear()
        self._f.write(_BGZF_EOF)
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class BamWriter:
    def __init__(self, path, ref_names, ref_lens):
        self._f = open(path, "wb")
        self._buf = bytearray()
        header_text = b"@HD\tVN:1.6\n"
        hdr = b"BAM\x01" + struct.pack("<i", len(header_text)) + header_text
        hdr += struct.pack("<i", len(ref_names))
        for nm, ln in zip(ref_names, ref_lens):
            nmb = nm.encode() + b"\x00"
            hdr += struct.pack("<i", len(nmb)) + nmb + struct.pack("<i", ln)
        self._buf += hdr
        self._maybe_flush()

    def write(self, name: str, flag: int, seq: np.ndarray,
              qual: np.ndarray | None = None, ref_id: int = -1,
              pos: int = -1, mapq: int = 0, cigar=None, tags: bytes = b"",
              next_ref_id: int = -1, next_pos: int = -1,
              tlen: int = 0) -> None:
        """seq: int8 codes in ORIGINAL read orientation; stored as-is with
        the FLAG given (callers set FLAG_REVERSE only if seq is already
        reverse-complemented to reference orientation).
        cigar: optional [(op_char, length)]; tags: raw BAM tag bytes
        (e.g. b'XFfA...' — use pack_tag_f for floats)."""
        nameb = name.encode() + b"\x00"
        l_seq = int(seq.size)
        packed = np.zeros((l_seq + 1) // 2, np.uint8)
        nt = _CODE_TO_NT16[np.clip(seq, 0, 4)]
        packed |= nt[0::2] << 4
        if l_seq > 1:
            packed[: l_seq // 2] |= nt[1::2]
        q = (np.full(l_seq, 0xFF, np.uint8) if qual is None
             else np.asarray(qual, np.uint8))
        cig = b"" if not cigar else b"".join(
            struct.pack("<I", (ln << 4) | _CIGAR_OPS.index(op))
            for op, ln in cigar)
        rec = struct.pack("<iiBBHHHi", ref_id, pos, len(nameb), mapq,
                          4680, len(cig) // 4, flag, l_seq)
        rec += struct.pack("<iii", next_ref_id, next_pos, tlen)
        rec += nameb + cig + packed.tobytes() + q.tobytes() + tags
        self._buf += struct.pack("<i", len(rec)) + rec
        self._maybe_flush()

    def _maybe_flush(self):
        while len(self._buf) >= 60000:
            self._f.write(_bgzf_block(bytes(self._buf[:60000])))
            del self._buf[:60000]

    def close(self):
        if self._buf:
            self._f.write(_bgzf_block(bytes(self._buf)))
            self._buf.clear()
        self._f.write(_BGZF_EOF)
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

"""BAI-indexed random access into coordinate-sorted BAM files.

The reference builds per-locus fetch regions and reads them through
htslib's indexed fetch (`command/genotype.rs:792-870`,
`seq/fastx.rs:586-660 IndexedReader`); this module owns the machinery:

* `reg2bin` / `reg2bins`: the 5-level UCSC binning scheme,
* `BaiIndex.load`: .bai parser (bins → chunks, 16 kb linear index,
  unplaced-read count),
* `build_bai`: writes the index of a coordinate-sorted BAM (samtools is
  not needed, and users get `locityper index` behavior for free),
* `fetch`: stream records overlapping a region via BGZF virtual-offset
  seeks, decompressing only the needed blocks,
* `fetch_unplaced`: the unmapped tail after the last placed record.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from .bam import SKIP_MASK, _NT16_TO_CODE, BamRecord, FLAG_REVERSE
from . import dna

_LINEAR_SHIFT = 14                          # 16 kb linear-index windows
# CIGAR ops consuming reference: M, D, N, =, X.
_REF_CONSUME = frozenset((0, 2, 3, 7, 8))


# ---------------------------------------------------------------------------
# Binning scheme (SAM spec §5.3)
# ---------------------------------------------------------------------------

def reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int) -> list[int]:
    """All bins that may contain records overlapping [beg, end)."""
    end -= 1
    bins = [0]
    for base, shift in ((1, 26), (9, 23), (73, 20), (585, 17), (4681, 14)):
        bins.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return bins


# ---------------------------------------------------------------------------
# BGZF block-level access
# ---------------------------------------------------------------------------

def _bgzf_block_at(fh, coffset: int) -> tuple[bytes, int]:
    """Decompresses the BGZF member starting at `coffset`; returns
    (payload, compressed_size).  Uses the mandatory BC extra subfield."""
    fh.seek(coffset)
    head = fh.read(18)
    if len(head) < 18:
        return b"", 0
    if head[:2] != b"\x1f\x8b":
        raise ValueError("BGZF: bad gzip magic at virtual seek target")
    (xlen,) = struct.unpack("<H", head[10:12])
    extra = head[12:12 + xlen] if xlen <= 6 else \
        head[12:18] + fh.read(xlen - 6)
    bsize = None
    i = 0
    while i + 4 <= len(extra):
        si1, si2, slen = extra[i], extra[i + 1], \
            struct.unpack("<H", extra[i + 2:i + 4])[0]
        if si1 == 66 and si2 == 67:             # 'B','C'
            bsize = struct.unpack("<H", extra[i + 4:i + 6])[0] + 1
            break
        i += 4 + slen
    if bsize is None:
        raise ValueError("BGZF: missing BC subfield (not a BGZF block)")
    fh.seek(coffset)
    blob = fh.read(bsize)
    payload = zlib.decompress(blob[12 + xlen:-8], -15)
    return payload, bsize


class VirtualReader:
    """Sequential reads across BGZF blocks starting at a virtual offset
    (coffset << 16 | uoffset), tracking the current virtual offset."""

    def __init__(self, fh):
        self.fh = fh
        self._coffset = -1
        self._payload = b""
        self._next_coffset = -1
        self._upos = 0

    def seek_virtual(self, voffset: int) -> None:
        coffset, upos = voffset >> 16, voffset & 0xFFFF
        if coffset != self._coffset:
            self._payload, csize = _bgzf_block_at(self.fh, coffset)
            self._coffset = coffset
            self._next_coffset = coffset + csize
        self._upos = upos

    @property
    def voffset(self) -> int:
        if self._upos >= len(self._payload) and self._payload:
            return self._next_coffset << 16
        return (self._coffset << 16) | self._upos

    def read(self, n: int) -> bytes:
        out = bytearray()
        while n > 0:
            if self._upos >= len(self._payload):
                payload, csize = _bgzf_block_at(self.fh, self._next_coffset)
                if not payload:
                    if csize == 0:
                        break               # true EOF
                    # empty block (EOF marker): skip it, leaving the stale
                    # payload exhausted (upos stays >= len)
                    self._coffset = self._next_coffset
                    self._next_coffset += csize
                    continue
                self._coffset = self._next_coffset
                self._next_coffset += csize
                self._payload = payload
                self._upos = 0
            take = min(n, len(self._payload) - self._upos)
            out += self._payload[self._upos:self._upos + take]
            self._upos += take
            n -= take
        return bytes(out)


# ---------------------------------------------------------------------------
# Record parsing (shared shape with bam.read_bam_records)
# ---------------------------------------------------------------------------

def _parse_record(rec: bytes) -> tuple[BamRecord, int]:
    """Parses one BAM record body; returns (BamRecord, ref_end).
    ref_end uses the CIGAR when present, else pos + l_seq."""
    ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq = \
        struct.unpack("<iiBBHHHi", rec[:20])
    off = 32
    name = rec[off:off + l_read_name - 1].decode()
    off += l_read_name
    span = 0
    for k in range(n_cigar):
        (op,) = struct.unpack("<I", rec[off + 4 * k:off + 4 * k + 4])
        if (op & 0xF) in _REF_CONSUME:
            span += op >> 4
    off += 4 * n_cigar
    packed = np.frombuffer(rec, np.uint8, (l_seq + 1) // 2, off)
    codes = np.empty(l_seq, np.int8)
    codes[0::2] = _NT16_TO_CODE[packed >> 4]
    if l_seq > 1:
        codes[1::2] = _NT16_TO_CODE[packed[:(l_seq // 2)] & 0xF]
    off += (l_seq + 1) // 2
    qual = np.frombuffer(rec, np.uint8, l_seq, off).copy()
    if qual.size and qual[0] == 0xFF:
        qual = None
    if flag & FLAG_REVERSE:
        codes = dna.revcomp(codes)
        if qual is not None:
            qual = qual[::-1].copy()
    end = pos + (span if span > 0 else l_seq)
    return BamRecord(name, flag, codes, qual, ref_id, pos, mapq), end


def read_header(vr: VirtualReader) -> tuple[list[str], list[int]]:
    """Reads the BAM header through `vr` (positioned at voffset 0); leaves
    `vr` at the first alignment record."""
    vr.seek_virtual(0)
    if vr.read(4) != b"BAM\x01":
        raise ValueError("not a BAM file")
    (l_text,) = struct.unpack("<i", vr.read(4))
    vr.read(l_text)
    (n_ref,) = struct.unpack("<i", vr.read(4))
    names, lens = [], []
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", vr.read(4))
        names.append(vr.read(l_name)[:-1].decode())
        lens.append(struct.unpack("<i", vr.read(4))[0])
    return names, lens


# ---------------------------------------------------------------------------
# Index container
# ---------------------------------------------------------------------------

class BaiIndex:
    def __init__(self, refs, n_no_coor: int = 0):
        # refs: list of (bins: dict bin -> [(chunk_beg, chunk_end)],
        #                linear: list[int])
        self.refs = refs
        self.n_no_coor = n_no_coor

    @classmethod
    def load(cls, path) -> "BaiIndex":
        data = Path(path).read_bytes()
        if data[:4] != b"BAI\x01":
            raise ValueError(f"{path}: not a BAI index")
        off = 4
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        refs = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            bins = {}
            for _ in range(n_bin):
                b, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    cb, ce = struct.unpack_from("<QQ", data, off)
                    off += 16
                    chunks.append((cb, ce))
                bins[b] = chunks
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4
            linear = list(struct.unpack_from(f"<{n_intv}Q", data, off))
            off += 8 * n_intv
            refs.append((bins, linear))
        n_no_coor = 0
        if off + 8 <= len(data):
            (n_no_coor,) = struct.unpack_from("<Q", data, off)
        return cls(refs, n_no_coor)

    def save(self, path) -> None:
        out = bytearray(b"BAI\x01")
        out += struct.pack("<i", len(self.refs))
        for bins, linear in self.refs:
            out += struct.pack("<i", len(bins))
            for b in sorted(bins):
                chunks = bins[b]
                out += struct.pack("<Ii", b, len(chunks))
                for cb, ce in chunks:
                    out += struct.pack("<QQ", cb, ce)
            out += struct.pack("<i", len(linear))
            out += struct.pack(f"<{len(linear)}Q", *linear)
        out += struct.pack("<Q", self.n_no_coor)
        Path(path).write_bytes(bytes(out))

    def chunks_for(self, ref_id: int, beg: int, end: int):
        """Merged chunk list possibly containing records overlapping
        [beg, end), pruned with the linear index."""
        if ref_id < 0 or ref_id >= len(self.refs):
            return []
        bins, linear = self.refs[ref_id]
        min_off = 0
        w = beg >> _LINEAR_SHIFT
        if w < len(linear):
            min_off = linear[w]
        chunks = []
        for b in reg2bins(beg, end):
            for cb, ce in bins.get(b, ()):
                if ce > min_off:
                    chunks.append((max(cb, min_off), ce))
        chunks.sort()
        merged = []
        for cb, ce in chunks:
            if merged and cb <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], ce))
            else:
                merged.append((cb, ce))
        return merged

    def last_placed_voffset(self) -> int:
        """Virtual offset just past the last placed record: where the
        unplaced (ref_id -1) tail begins."""
        v = 0
        for bins, _linear in self.refs:
            for chunks in bins.values():
                for _cb, ce in chunks:
                    v = max(v, ce)
        return v


# ---------------------------------------------------------------------------
# Index building (coordinate-sorted BAM)
# ---------------------------------------------------------------------------

def build_bai(bam_path, bai_path=None) -> BaiIndex:
    """Builds and writes a .bai for a coordinate-sorted BAM (the samtools
    `index` role).  Raises if the file is not coordinate-sorted."""
    bai_path = bai_path or (str(bam_path) + ".bai")
    with open(bam_path, "rb") as fh:
        vr = VirtualReader(fh)
        names, _lens = read_header(vr)
        refs = [({}, []) for _ in names]
        n_no_coor = 0
        last = (-1, -1)
        while True:
            v0 = vr.voffset
            head = vr.read(4)
            if len(head) < 4:
                break
            (block_size,) = struct.unpack("<i", head)
            rec = vr.read(block_size)
            v1 = vr.voffset
            ref_id, pos, _lrn, _mapq, _bin, n_cigar, flag, l_seq = \
                struct.unpack("<iiBBHHHi", rec[:20])
            if ref_id < 0:
                n_no_coor += 1
                continue
            if ref_id < last[0] or (ref_id == last[0] and pos < last[1]):
                raise ValueError(f"{bam_path}: not coordinate-sorted "
                                 f"(ref {ref_id}:{pos} after {last})")
            last = (ref_id, pos)
            span = 0
            off = 32 + rec[8]                   # l_read_name at byte 8
            for k in range(n_cigar):
                (op,) = struct.unpack("<I", rec[off + 4 * k:off + 4 * k + 4])
                if (op & 0xF) in _REF_CONSUME:
                    span += op >> 4
            end = pos + (span if span > 0 else max(l_seq, 1))
            bins, linear = refs[ref_id]
            b = reg2bin(pos, end)
            if b in bins and bins[b][-1][1] == v0:
                bins[b][-1] = (bins[b][-1][0], v1)
            else:
                bins.setdefault(b, []).append((v0, v1))
            w_beg, w_end = pos >> _LINEAR_SHIFT, (end - 1) >> _LINEAR_SHIFT
            while len(linear) <= w_end:
                linear.append(0)
            for w in range(w_beg, w_end + 1):
                if linear[w] == 0 or v0 < linear[w]:
                    linear[w] = v0 if linear[w] == 0 else min(linear[w], v0)
    idx = BaiIndex(refs, n_no_coor)
    idx.save(bai_path)
    return idx


# ---------------------------------------------------------------------------
# Fetch
# ---------------------------------------------------------------------------

def fetch(bam_path, index: BaiIndex, ref_id: int, beg: int, end: int,
          keep_flags: int = SKIP_MASK):
    """Yields BamRecord overlapping [beg, end) on ref_id, decompressing
    only the indexed chunks (fastx.rs IndexedReader role)."""
    chunks = index.chunks_for(ref_id, beg, end)
    if not chunks:
        return
    with open(bam_path, "rb") as fh:
        vr = VirtualReader(fh)
        for cb, ce in chunks:
            vr.seek_virtual(cb)
            while vr.voffset < ce:
                head = vr.read(4)
                if len(head) < 4:
                    break
                (block_size,) = struct.unpack("<i", head)
                rec_bytes = vr.read(block_size)
                r_ref, r_pos = struct.unpack("<ii", rec_bytes[:8])
                if r_ref != ref_id:
                    break
                if r_pos >= end:
                    break
                rec, r_end = _parse_record(rec_bytes)
                if rec.flag & keep_flags:
                    continue
                if r_end > beg:
                    yield rec


def fetch_unplaced(bam_path, index: BaiIndex,
                   keep_flags: int = SKIP_MASK):
    """Yields the unplaced (ref_id -1) records at the end of a
    coordinate-sorted BAM (the reference also feeds unmapped reads to
    recruitment, genotype.rs:835-852)."""
    if index.n_no_coor == 0:
        return
    start = index.last_placed_voffset()
    with open(bam_path, "rb") as fh:
        vr = VirtualReader(fh)
        if start == 0:
            read_header(vr)
        else:
            vr.seek_virtual(start)
        while True:
            head = vr.read(4)
            if len(head) < 4:
                return
            (block_size,) = struct.unpack("<i", head)
            rec_bytes = vr.read(block_size)
            if len(rec_bytes) < block_size:
                return
            (r_ref,) = struct.unpack("<i", rec_bytes[:4])
            if r_ref >= 0:
                continue
            rec, _ = _parse_record(rec_bytes)
            if not (rec.flag & keep_flags):
                yield rec

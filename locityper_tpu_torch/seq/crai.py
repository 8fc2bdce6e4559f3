"""CRAI (CRAM index) build / parse / region fetch.

The reference fetches regions from any coordinate-sorted, indexed
BAM/CRAM through htslib (seq/fastx.rs:586-887; fetch regions assembled in
command/genotype.rs:792-870).  This module owns the CRAM side: a .crai is
gzip-compressed text, one line per slice —

    ref_seq_id  aln_start(1-based)  aln_span  container_offset
    slice_header_offset  slice_size_bytes

(CRAM 3.0 spec §4).  Fetch decodes only the containers whose index
entries overlap the query region; records are then filtered exactly by
their decoded [pos, end) span.  Multi-reference containers (ref_seq_id
-2) are always candidates and rely on the per-record filter.
"""
from __future__ import annotations

import gzip
from dataclasses import dataclass
from pathlib import Path

from .cram import SKIP_MASK, CramFile

FLAG_UNMAPPED = 0x4


@dataclass
class CraiEntry:
    ref_id: int
    start: int                  # 0-based inclusive
    span: int
    c_offset: int               # container byte offset in the .cram
    s_offset: int               # slice header byte offset within container
    s_len: int                  # slice size in bytes

    @property
    def end(self) -> int:
        return self.start + self.span


class CraiIndex:
    def __init__(self, entries: list[CraiEntry]):
        self.entries = entries

    @classmethod
    def load(cls, path) -> "CraiIndex":
        entries = []
        with gzip.open(path, "rt") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                cols = line.split("\t")
                if len(cols) != 6:
                    raise ValueError(f"{path}: malformed .crai line {line!r}")
                rid, start, span, coff, soff, slen = (int(c) for c in cols)
                entries.append(CraiEntry(rid, start - 1 if rid >= 0 else 0,
                                         span, coff, soff, slen))
        return cls(entries)

    def save(self, path) -> None:
        with gzip.open(path, "wt") as f:
            for e in self.entries:
                f.write(f"{e.ref_id}\t{e.start + 1 if e.ref_id >= 0 else 0}\t"
                        f"{e.span}\t{e.c_offset}\t{e.s_offset}\t{e.s_len}\n")

    def container_offsets(self, rid: int, start: int, end: int) -> list[int]:
        """Distinct container offsets whose entries overlap [start, end) of
        reference `rid` — plus every multi-ref (-2) container, which can
        only be filtered after decoding."""
        offs = {e.c_offset for e in self.entries
                if e.ref_id == -2
                or (e.ref_id == rid and e.start < end and e.end > start)}
        return sorted(offs)

    def unplaced_offsets(self) -> list[int]:
        """Containers that may hold unmapped-unplaced records (ref -1 or
        multi-ref)."""
        return sorted({e.c_offset for e in self.entries
                       if e.ref_id in (-1, -2)})


def build_crai(cram_path, out_path=None) -> CraiIndex:
    """Builds a .crai by scanning container headers (one entry per
    container: single-slice containers — the only kind our writer emits —
    index identically to per-slice entries; fetch only ever uses the
    container offset anyway).  Requires position-sorted input like
    `samtools index`."""
    entries = []
    with CramFile(cram_path) as cf:
        for off, hdr in cf.containers():
            entries.append(CraiEntry(hdr.ref_seq_id,
                                     hdr.start - 1 if hdr.ref_seq_id >= 0
                                     else 0,
                                     hdr.span, off, 0, hdr.length))
    idx = CraiIndex(entries)
    if out_path is None:
        out_path = str(cram_path) + ".crai"
    idx.save(out_path)
    return idx


def fetch(cram_path, idx: CraiIndex, rid: int, start: int, end: int,
          reference=None, keep_flags: int = SKIP_MASK, cram=None):
    """Yields primary records overlapping [start, end) (0-based) of
    reference `rid`, decoding only the containers the index points at.

    cram: an already-open CramFile to reuse across calls — opening one
    re-parses the reference FASTA, so multi-region callers MUST share one
    (seq/inputs.py:crai_records)."""
    cf = cram if cram is not None else CramFile(cram_path, reference)
    try:
        for off in idx.container_offsets(rid, start, end):
            for r in cf.container_records(off):
                if r.flag & keep_flags:
                    continue
                if r.ref_id == rid and r.pos < end and r.end > start:
                    yield r
    finally:
        if cram is None:
            cf.close()


def fetch_unplaced(cram_path, idx: CraiIndex, reference=None,
                   keep_flags: int = SKIP_MASK, cram=None):
    """Yields unmapped-unplaced primary records (ref_id -1), e.g. mates
    of reads whose placements were filtered away (fastx.rs:640-660)."""
    cf = cram if cram is not None else CramFile(cram_path, reference)
    try:
        for off in idx.unplaced_offsets():
            for r in cf.container_records(off):
                if r.flag & keep_flags:
                    continue
                if r.ref_id < 0 or (r.flag & FLAG_UNMAPPED and r.pos < 0):
                    yield r
    finally:
        if cram is None:
            cf.close()


def index_path(cram_path) -> Path:
    return Path(str(cram_path) + ".crai")

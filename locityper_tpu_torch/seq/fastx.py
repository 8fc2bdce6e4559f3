"""FASTA/FASTQ reading & writing (counterpart of reference seq/fastx.rs).

Host-side streaming parsers producing numpy code arrays; reads are consumed
in fixed-size *batches* (dense [B, L] int8 tensors + length vectors) — the
shape the device kernels operate on.  Gzip handled transparently.
"""
from __future__ import annotations

import operator
from dataclasses import dataclass

import numpy as np

from ..utils import spans
from ..utils.io import Prefetch, smart_open, smart_open_bytes
from . import dna

#: Decompressed bytes fed to the native FASTQ parser per chunk.  Module
#: constant so tests can shrink it to exercise chunk-boundary framing
#: (tests/test_native.py::test_chunk_boundary_framing).
_CHUNK_BYTES = 1 << 22


@dataclass
class Read:
    name: str
    seq: np.ndarray            # int8 codes
    qual: np.ndarray | None = None


def _fasta_records(f):
    name = None
    chunks: list[str] = []
    for line in f:
        line = line.rstrip()
        if not line:
            continue
        if line.startswith(">"):
            if name is not None:
                yield name, dna.encode("".join(chunks))
            name = line[1:].split()[0]
            chunks = []
        else:
            chunks.append(line)
    if name is not None:
        yield name, dna.encode("".join(chunks))


def _fastq_records(f):
    while True:
        header = f.readline()
        if not header:
            return
        seq = f.readline().rstrip()
        f.readline()  # +
        qual = f.readline().rstrip()
        yield Read(header[1:].rstrip().split()[0], dna.encode(seq),
                   np.frombuffer(qual.encode(), dtype=np.uint8) - 33)


def read_fasta(path):
    """Yields (name, codes) from a (possibly gzipped) FASTA file."""
    with smart_open(path) as f:
        yield from _fasta_records(f)


def read_fastq(path):
    """Yields Read from a (possibly gzipped) FASTQ file."""
    with smart_open(path) as f:
        yield from _fastq_records(f)


def read_fastx_auto(path):
    """Dispatch on extension/first line: BAM (primary records), FASTA
    (qual=None) or FASTQ.  Sniffs and parses within ONE open so the file
    is read exactly once (preproc counts IO passes)."""
    if str(path).endswith((".bam", ".cram")):
        from . import bam
        yield from bam.read_bam(path)
        return
    from itertools import chain
    with smart_open(path) as f:
        first = f.readline()
        if not first:
            return
        rest = chain([first], f)
        if first.startswith(">"):
            for name, codes in _fasta_records(rest):
                yield Read(name, codes)
        else:
            # FASTQ via readline: replay the sniffed header line.
            class _Replay:
                def __init__(self, line, fh):
                    self._line, self._fh = line, fh

                def readline(self):
                    if self._line is not None:
                        line, self._line = self._line, None
                        return line
                    return self._fh.readline()
            yield from _fastq_records(_Replay(first, f))


def read_pairs(path1, path2=None, interleaved: bool = False):
    """Yields (Read, Read) mate pairs: from two files, one interleaved file,
    or one BAM with FLAG-based mate matching (fastx.rs:430-536, 700-887)."""
    if path2 is None and str(path1).endswith((".bam", ".cram")):
        from . import bam
        yield from bam.read_bam_pairs(path1)
        return
    if path2 is not None:
        it1, it2 = read_fastx_auto(path1), read_fastx_auto(path2)
        for r1 in it1:
            r2 = next(it2, None)
            if r2 is None:
                raise ValueError("Second mate file ended early")
            yield r1, r2
    elif interleaved:
        it = read_fastx_auto(path1)
        for r1 in it:
            r2 = next(it, None)
            if r2 is None:
                raise ValueError("Odd number of reads in interleaved file")
            yield r1, r2
    else:
        raise ValueError("read_pairs needs a second file or interleaved=True")


def write_fasta(f, name: str, codes: np.ndarray, width: int = 120) -> None:
    s = dna.decode(codes)
    f.write(f">{name}\n")
    for i in range(0, len(s), width):
        f.write(s[i:i + width] + "\n")


def write_fastq(f, read: Read) -> None:
    s = dna.decode(read.seq)
    q = "~" * len(s) if read.qual is None else (read.qual + 33).tobytes().decode()
    f.write(f"@{read.name}\n{s}\n+\n{q}\n")


def mean_read_len(path, max_reads: int = 1000) -> float:
    """Mean length of the first `max_reads` reads (fastx.rs:889)."""
    total = 0
    n = 0
    for read in read_fastx_auto(path):
        total += read.seq.size
        n += 1
        if n >= max_reads:
            break
    return total / max(n, 1)


class MaxLenExceeded(Exception):
    """A read longer than the batch width appeared mid-stream.  Carries the
    longest true length seen so the caller can re-size and retry — reference
    recruitment always sees full reads (recruit.rs:852-932), so silent
    clipping is never acceptable."""

    def __init__(self, max_seen: int):
        super().__init__(f"read of {max_seen} bp exceeds the batch width")
        self.max_seen = max_seen


def _bucket_len(n: int) -> int:
    """Device-shape bucketing for read widths: 64-multiples, floor 192 (the
    historical short-read width, keeps compiled-kernel shapes stable)."""
    return max(192, -(-int(n) // 64) * 64)


def is_fastq_files(paths) -> bool:
    """True iff every path is (decompressed) FASTQ — first non-whitespace
    byte is '@'.  Gates the native-parser fast paths: the C++ parser
    handles FASTQ only, and feeding it FASTA would silently yield zero
    records (kernels.cpp stops at a non-'@' record start)."""
    for path in paths:
        try:
            with smart_open_bytes(path) as f:
                head = f.read(64).lstrip()
                while not head:                     # all-whitespace chunk
                    chunk = f.read(64)
                    if not chunk:
                        break                       # EOF: empty file
                    head = chunk.lstrip()
        except OSError:
            return False
        if not head[:1] == b"@":
            return False
    return True


def probe_fastq_max_len(paths, n_bytes: int = 1 << 22) -> int:
    """Longest sequence among the leading records of each file (one
    decompressed chunk per file).  Sizes the dense batch width so typical
    uniform-length libraries never trigger a mid-stream re-size."""
    longest = 0
    for path in paths:
        with smart_open_bytes(path) as f:
            data = f.read(n_bytes)
        lines = data.split(b"\n")
        # Sequence is line 2 of each 4-line record; drop the (possibly
        # truncated) final line.
        for i in range(1, max(len(lines) - 1, 1), 4):
            if len(lines[i]) > longest:
                longest = len(lines[i])
    return longest


class NameColumn:
    """The read names of a batch, kept as one flat byte string and offsets:
    `names[i]` decodes row i's name to `str` (counted in the open call's
    `names_decoded`), `names[a:b]` is a column of those rows, `len(names)`
    the rows.  Recruitment decodes only the names of the pairs it keeps."""

    __slots__ = ("_flat", "_ends")

    def __init__(self, flat: bytes, ends: np.ndarray):
        self._flat = flat       # the names, one after another
        self._ends = ends       # [rows + 1] int64; row i: ends[i]:ends[i + 1]

    def __len__(self) -> int:
        return self._ends.size - 1

    def __getitem__(self, i):
        if isinstance(i, slice):
            start, stop, step = i.indices(len(self))
            if step != 1:
                raise ValueError("NameColumn slices take no step")
            return NameColumn(self._flat,
                              self._ends[start:max(stop, start) + 1])
        i = operator.index(i)
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        spans.count("names_decoded", 1)
        return self._flat[self._ends[i]:self._ends[i + 1]].decode()


class _Block:
    """One mate's [batch, max_len] block of parsed records, filled by
    successive parser calls (`rows` so far), with its names when kept."""

    def __init__(self, batch: int, max_len: int, keep_names: bool):
        self.codes = np.empty((batch, max_len), np.int8)
        self.lens = np.empty(batch, np.int32)
        self.rows = 0
        self._pieces = [] if keep_names else None
        self._ends = np.zeros(batch + 1, np.int64) if keep_names else None

    def add_names(self, buf, name_off, name_len) -> None:
        """Copies the names of the rows just parsed out of `buf`, in one
        gather a parser call."""
        if self._pieces is None or not name_len.size:
            return
        ends = np.cumsum(name_len, dtype=np.int64)
        starts = np.repeat(name_off - (ends - name_len), name_len)
        self._pieces.append(buf[starts + np.arange(ends[-1])])
        r = self.rows
        self._ends[r + 1:r + 1 + ends.size] = self._ends[r] + ends

    @property
    def names(self):
        if self._pieces is None:
            return None
        flat = np.concatenate(self._pieces) if self._pieces \
            else np.empty(0, np.uint8)
        return NameColumn(flat.tobytes(), self._ends[:self.rows + 1])


def _mate_blocks(path, mate: int, batch: int, max_len: int,
                 keep_names: bool, span_parent):
    """Inflates and parses one mate file into _Blocks of `batch` records
    (the last one partial), one `recruit.mate` span a chunk.  The
    decompressed bytes go to one reused buffer, from which the parser
    fills the block's rows directly."""
    from .. import native

    name_off = np.empty(batch, np.int64)
    name_len = np.empty(batch, np.int32)
    buf = bytearray()
    block = _Block(batch, max_len, keep_names)
    with smart_open_bytes(path) as f:
        while True:
            full = []
            with spans.span("recruit.mate", parent=span_parent,
                            mate=mate) as sp:
                data = f.read(_CHUNK_BYTES)
                spans.count("fastq_bytes", len(data))
                buf += data
                arr = np.frombuffer(buf, np.uint8)
                pos = records = 0
                while True:
                    r = block.rows
                    cnt, used, max_seen = native.parse_fastq_into(
                        arr[pos:], block.codes[r:], block.lens[r:],
                        name_off, name_len)
                    if max_seen > max_len:
                        raise MaxLenExceeded(max_seen)
                    block.add_names(arr[pos:], name_off[:cnt],
                                    name_len[:cnt])
                    block.rows += cnt
                    pos += used
                    records += cnt
                    if block.rows < batch:
                        break
                    full.append(block)
                    block = _Block(batch, max_len, keep_names)
                del arr
                del buf[:pos]
                # Chunk-boundary hazard (found at 100-locus scale): when a
                # record's trailing newline falls EXACTLY on the chunk
                # boundary, the parser consumes the record (its qual is
                # complete — qual length must equal seq length, so nothing
                # can follow) and the orphan '\n' arrives at the head of
                # the next chunk, where the parser refuses to parse
                # anything and the stream would silently truncate.
                if buf[:1] == b"\n":
                    del buf[:len(buf) - len(buf.lstrip(b"\n"))]
                sp.attrs["records"] = records
            yield from full
            if not data:
                break
    if block.rows:
        yield block


def fast_paired_batches(path1, path2, batch: int = 4096,
                        max_len: int | None = None, span_parent=None):
    """Streams paired FASTQ files as dense batches using the native C++
    parser (native/): yields (names, m1 [B, max_len] int8, lens1, m2,
    lens2, count).  Falls back to the Python reader when the native library
    is unavailable.

    With the native parser, each mate file is inflated (Python's zlib) and
    parsed on a thread of its own (`_mate_blocks` under a Prefetch,
    threads `fastq-mate1` and `fastq-mate2`), straight into whole
    [batch, max_len] blocks, with no Python work a record; `names` is a
    NameColumn of mate 1's names, decoded only where a row is indexed, and
    mate 2's names are never kept.  The generator's own thread pairs the
    two mates' blocks: each batch is one `recruit.read` span (attribute
    `pairs`, including the wait on the mate threads), each chunk of a mate
    one `recruit.mate` span (`mate`, `records`) on that mate's thread, all
    naming `span_parent` as their parent (utils/spans.py); every chunk's
    decompressed bytes are added to the open call's counter `fastq_bytes`.
    The stream ends with the shorter file; closing the generator stops and
    joins both mate threads.

    max_len=None sizes the batch width from the files' leading records
    (64-bucketed, floor 192).  If a longer read appears mid-stream, raises
    MaxLenExceeded instead of clipping — callers retry with the reported
    width (reference recruitment never clips reads, recruit.rs:852-932)."""
    from .. import native
    if max_len is None:
        max_len = _bucket_len(probe_fastq_max_len((path1, path2)))
    if not native.available():
        names, r1s, r2s = [], [], []
        for r1, r2 in read_pairs(path1, path2):
            if r1.seq.size > max_len or r2.seq.size > max_len:
                raise MaxLenExceeded(max(r1.seq.size, r2.seq.size))
            names.append(r1.name)
            r1s.append(r1.seq)
            r2s.append(r2.seq)
            if len(names) == batch:
                yield _pack_pairs(names, r1s, r2s, max_len)
                names, r1s, r2s = [], [], []
        if names:
            yield _pack_pairs(names, r1s, r2s, max_len)
        return

    mates = [Prefetch(_mate_blocks(path, mate, batch, max_len, mate == 1,
                                   span_parent), name=f"fastq-mate{mate}")
             for mate, path in ((1, path1), (2, path2))]
    try:
        while True:
            # The span closes before the yield: a consumer's wait is not
            # the reader's work.
            with spans.span("recruit.read", parent=span_parent) as read:
                b1, b2 = (next(m, None) for m in mates)
                n = min(b1.rows if b1 else 0, b2.rows if b2 else 0)
                read.attrs["pairs"] = n
                if 0 < n < batch:
                    # Pad the final partial batch to the full batch shape
                    # so device kernels see one stable shape.
                    for b in (b1, b2):
                        b.codes[n:] = dna.N_CODE
                        b.lens[n:] = 0
                if n:
                    item = (b1.names[:n], b1.codes, b1.lens, b2.codes,
                            b2.lens, n)
            if n == 0:
                return
            yield item
            if n < batch:
                return
    finally:
        for m in mates:
            m.close()


def _pack_pairs(names, r1s, r2s, max_len):
    n = len(names)
    m1 = np.full((n, max_len), 4, np.int8)
    m2 = np.full((n, max_len), 4, np.int8)
    l1 = np.zeros(n, np.int32)
    l2 = np.zeros(n, np.int32)
    for i, (a, b) in enumerate(zip(r1s, r2s)):
        L1, L2 = min(a.size, max_len), min(b.size, max_len)
        m1[i, :L1] = a[:L1]
        m2[i, :L2] = b[:L2]
        l1[i], l2[i] = L1, L2
    return names, m1, l1, m2, l2, n


def batchify(reads: list[np.ndarray], batch: int, max_len: int,
             pad_to_batch: bool = True):
    """Packs variable-length code arrays into dense [B, max_len] int8 batches
    (pad = N code) plus an int32 length vector — the device-kernel input
    layout (design: SURVEY.md §7 'irregular data → dense tensors')."""
    for i in range(0, len(reads), batch):
        chunk = reads[i:i + batch]
        b = len(chunk) if not pad_to_batch else batch
        mat = np.full((b, max_len), dna.N_CODE, dtype=np.int8)
        lens = np.zeros(b, dtype=np.int32)
        for j, r in enumerate(chunk):
            L = min(r.size, max_len)
            mat[j, :L] = r[:L]
            lens[j] = L
        yield mat, lens, len(chunk)

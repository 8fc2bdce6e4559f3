"""FASTA/FASTQ reading & writing (counterpart of reference seq/fastx.rs).

Host-side streaming parsers producing numpy code arrays; reads are consumed
in fixed-size *batches* (dense [B, L] int8 tensors + length vectors) — the
shape the device kernels operate on.  Gzip handled transparently.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.io import smart_open
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
    from ..utils.io import smart_open_bytes
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
    from ..utils.io import smart_open_bytes
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


def fast_paired_batches(path1, path2, batch: int = 4096,
                        max_len: int | None = None, span_parent=None):
    """Streams paired FASTQ files as dense batches using the native C++
    parser (native/): yields (names, m1 [B, max_len] int8,
    lens1, m2, lens2, count).  Decompression stays in Python (zlib C under
    the hood); record parsing and encoding run natively.  Falls back to the
    Python reader when the native library is unavailable.

    With the native parser, each batch's inflate, parse and packing is one
    `recruit.read` span (utils/spans.py, attribute `pairs`) naming
    `span_parent` as its parent, since it runs on whichever thread draws
    from the generator; every chunk's decompressed bytes are added to the
    open call's counter `fastq_bytes`.

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

    from ..utils import spans
    from ..utils.io import smart_open_bytes

    class _ChunkQueue:
        """Parsed-chunk FIFO: take(n) assembles [n, max_len] blocks by array
        slicing — no per-read Python (the parser already returns dense
        arrays)."""

        def __init__(self, path):
            # One parse thread per file: the outer recruit prefetch
            # already hides parsing behind the consumer's work.
            self._gen = self._chunks(path)
            self._parts = []            # [(codes, lens, names, offset)]
            self.eof = False

        @staticmethod
        def _chunks(path):
            buf = b""
            with smart_open_bytes(path) as f:
                while True:
                    data = f.read(_CHUNK_BYTES)
                    spans.count("fastq_bytes", len(data))
                    if not data and not buf.strip(b"\n"):
                        return
                    buf += data
                    codes, lens, names, consumed, max_seen = \
                        native.parse_fastq_buffer(buf, max_len, batch * 4)
                    if max_seen > max_len:
                        raise MaxLenExceeded(max_seen)
                    if consumed == 0 and not data:
                        return
                    buf = buf[consumed:]
                    # Chunk-boundary hazard (found at 100-locus
                    # scale): when a record's trailing newline falls
                    # EXACTLY on the chunk boundary, the parser consumes
                    # the record (its qual is complete — qual length must
                    # equal seq length, so nothing can follow) and the
                    # orphan '\n' arrives at the head of the next chunk,
                    # where the parser refuses to parse anything
                    # (consumed=0) and the stream silently truncates.
                    buf = buf.lstrip(b"\n")
                    if names:
                        yield codes[:len(names)], lens[:len(names)], names

        def take(self, n):
            have = sum(c[0].shape[0] - c[3] for c in self._parts)
            while have < n and not self.eof:
                nxt = next(self._gen, None)
                if nxt is None:
                    self.eof = True
                    break
                self._parts.append([nxt[0], nxt[1], nxt[2], 0])
                have += nxt[0].shape[0]
            out_c, out_l, out_n = [], [], []
            need = n
            while need and self._parts:
                codes, lens, names, off = self._parts[0]
                k = min(need, codes.shape[0] - off)
                out_c.append(codes[off:off + k])
                out_l.append(lens[off:off + k])
                out_n.extend(names[off:off + k])
                need -= k
                if off + k == codes.shape[0]:
                    self._parts.pop(0)
                else:
                    self._parts[0][3] = off + k
            if not out_c:
                return None, None, []
            return (np.concatenate(out_c), np.concatenate(out_l), out_n)

    q1, q2 = _ChunkQueue(path1), _ChunkQueue(path2)
    while True:
        # The span closes before the yield: a consumer's wait is not the
        # reader's work.
        with spans.span("recruit.read", parent=span_parent) as read:
            c1, l1, n1 = q1.take(batch)
            c2, l2, n2 = q2.take(batch)
            n = min(len(n1), len(n2))
            read.attrs["pairs"] = n
            if n == batch:
                item = (n1, c1, l1.astype(np.int32), c2,
                        l2.astype(np.int32), batch)
            elif n:
                # Pad the final partial batch to the full batch shape so
                # device kernels see one stable shape.
                m1 = np.full((batch, max_len), 4, np.int8)
                m2 = np.full((batch, max_len), 4, np.int8)
                m1[:n] = c1[:n]
                m2[:n] = c2[:n]
                fl1 = np.zeros(batch, np.int32)
                fl2 = np.zeros(batch, np.int32)
                fl1[:n] = l1[:n]
                fl2[:n] = l2[:n]
                item = (n1[:n], m1, fl1, m2, fl2, n)
        if n == 0:
            return
        yield item
        if n < batch:
            return


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

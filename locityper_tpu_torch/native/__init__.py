"""ctypes bindings for the native host kernels (kernels.cpp).

The library is built on demand with `make` (g++); every entry point has a
numpy fallback in pure Python modules, so the package works without a
toolchain — the native path is a drop-in speedup for host-side parsing and
k-mer work (counterpart of the reference's compiled Rust host runtime).

Several processes may load the package at once (test workers, the
processes of a multi-process run, a cohort run in parallel): the build and
the load happen under an exclusive lock on a file beside the library, and
the Makefile writes the library under a temporary name and renames it into
place, so no process ever loads a partly written file.
"""
from __future__ import annotations

import ctypes
import fcntl
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).parent
_LIB_PATH = _DIR / "libkernels.so"
_LOCK_PATH = _DIR / ".libkernels.lock"
_lib = None
_tried = False
_load_lock = threading.Lock()

logger = logging.getLogger("locityper.native")


def _build() -> None:
    """Brings the library up to date with kernels.cpp (`make` does nothing
    when it is newer).  Without `make` or a C++ compiler the numpy
    fallbacks serve; a build that fails with both present is logged."""
    cxx = os.environ.get("CXX", "g++")
    if shutil.which("make") is None or shutil.which(cxx) is None:
        return
    try:
        subprocess.run(["make", "-C", str(_DIR), "-s"], check=True,
                       capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as exc:
        logger.warning("building %s failed (numpy fallbacks in use): %s",
                       _LIB_PATH, getattr(exc, "stderr", None) or exc)


def _load():
    """Builds and loads the library under an exclusive lock on a file
    beside it, held across processes; None when there is none to load.  A
    directory that cannot hold the lock file cannot be built in either."""
    try:
        fd = os.open(_LOCK_PATH, os.O_RDWR | os.O_CREAT, 0o644)
    except OSError:
        fd = None
    try:
        if fd is not None:
            fcntl.flock(fd, fcntl.LOCK_EX)
            _build()
        if _LIB_PATH.exists():
            return ctypes.CDLL(str(_LIB_PATH))
    except OSError as exc:
        logger.warning("loading %s failed (numpy fallbacks in use): %s",
                       _LIB_PATH, exc)
    finally:
        if fd is not None:
            os.close(fd)        # releases the lock
    return None


def get_lib():
    """Returns the loaded library or None (fallback mode).  The first call
    of a process builds and loads it; later calls return that result."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _load_lock:
        if _tried:
            return _lib
        lib = _load()
        if lib is not None:
            _bind(lib)
        _lib = lib
        _tried = True
    return _lib


def _bind(lib) -> None:
    """Declares the argument and result types of the library's functions."""
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")

    lib.encode_dna.argtypes = [u8p, ctypes.c_int64, i8p]
    lib.pack_codes4.argtypes = [i8p, ctypes.c_int64, ctypes.c_int64, u32p]
    lib.pack_codes4s.argtypes = [i8p, ctypes.c_int64, ctypes.c_int64, u32p,
                                 ctypes.c_int64, ctypes.c_int64]
    lib.canonical_kmers.argtypes = [i8p, ctypes.c_int64, ctypes.c_int32,
                                    u64p, u8p, u8p]
    lib.minimizers32.argtypes = [i8p, ctypes.c_int64, ctypes.c_int32,
                                 ctypes.c_int32, i64p, u32p, u8p]
    lib.minimizers32.restype = ctypes.c_int64
    lib.parse_fastq.argtypes = [u8p, ctypes.c_int64, ctypes.c_int32,
                                ctypes.c_int64, i8p, i32p, i64p, i32p,
                                ctypes.POINTER(ctypes.c_int64),
                                ctypes.POINTER(ctypes.c_int32)]
    lib.parse_fastq.restype = ctypes.c_int64
    lib.fastq_complete_prefix.argtypes = [u8p, ctypes.c_int64]
    lib.fastq_complete_prefix.restype = ctypes.c_int64
    lib.minimizers32_batch.argtypes = [i8p, i64p, ctypes.c_int64,
                                       ctypes.c_int32, ctypes.c_int32,
                                       i64p, i64p, u32p, u8p,
                                       ctypes.c_int64]
    lib.minimizers32_batch.restype = ctypes.c_int64
    lib.count_unique_nonoverlap.argtypes = [i8p, ctypes.c_int64,
                                            ctypes.c_int32, u64p,
                                            ctypes.c_int64]
    lib.count_unique_nonoverlap.restype = ctypes.c_int64
    lib.count_unique_nonoverlap_batch.argtypes = [
        i8p, i64p, ctypes.c_int64, ctypes.c_int32, u64p, ctypes.c_int64,
        i64p]
    lib.anchor_votes.argtypes = [
        i64p, i64p, u32p, u8p, ctypes.c_int64,          # minimizers
        i64p, ctypes.c_int64,                           # rlens
        u32p, i32p, i32p, u8p, ctypes.c_int64,          # index
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i64p, i64p, i64p, i64p, ctypes.c_int64]
    lib.anchor_votes.restype = ctypes.c_int64
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    lib.banded_align_cigar.argtypes = [
        i8p, ctypes.c_int64, i8p, ctypes.c_int64, ctypes.c_int32, f32p,
        ctypes.c_int64, i32p, i32p, ctypes.c_int64, i32p,
        ctypes.POINTER(ctypes.c_float)]
    lib.banded_align_cigar.restype = ctypes.c_int64
    lib.kmer_fp_sorted.argtypes = [i8p, ctypes.c_int64, ctypes.c_int32,
                                   u32p, u64p, u64p]
    lib.kmer_fp_sorted.restype = ctypes.c_int64
    lib.kmer_match_join.argtypes = [
        i8p, u32p, u64p, u64p, ctypes.c_int64,
        i8p, u32p, u64p, u64p, ctypes.c_int64,
        ctypes.c_int32, u32p, u32p, ctypes.c_int64]
    lib.kmer_match_join.restype = ctypes.c_int64
    lib.chain_align.argtypes = [
        i8p, ctypes.c_int64, i8p, ctypes.c_int64,
        u32p, u32p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, i32p, i32p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.chain_align.restype = ctypes.c_int64


def available() -> bool:
    return get_lib() is not None


def pack_codes4(mats) -> np.ndarray:
    """Concatenate [B, L] int8 code matrices (L % 8 == 0) row-wise into a
    single [sum(B), L/8] uint32 4-bit-packed matrix (two bases per byte,
    little-endian nibbles)."""
    lib = get_lib()
    L = mats[0].shape[1]
    total = sum(m.shape[0] for m in mats)
    out = np.empty((total, L // 8), np.uint32)
    row = 0
    for m in mats:
        b = m.shape[0]
        lib.pack_codes4(np.ascontiguousarray(m), b, L, out[row:row + b])
        row += b
    return out


def pack_codes4_strided(mat: np.ndarray, out: np.ndarray,
                        col_off: int) -> None:
    """Pack [N, L] int8 codes 4-bit into out[:, col_off:col_off+L/8] of a
    C-contiguous [N, stride] uint32 buffer (combined-upload assembly)."""
    lib = get_lib()
    n, L = mat.shape
    lib.pack_codes4s(np.ascontiguousarray(mat), n, L, out, out.shape[1],
                     col_off)


def minimizers32(codes: np.ndarray, k: int, w: int):
    """Native minimizers32; same contract as seq.kmers.minimizers32."""
    lib = get_lib()
    n = codes.size
    cap = max(n, 1)
    pos = np.empty(cap, np.int64)
    hashes = np.empty(cap, np.uint32)
    fwd = np.empty(cap, np.uint8)
    cnt = lib.minimizers32(np.ascontiguousarray(codes), n, k, w, pos, hashes, fwd)
    return pos[:cnt], hashes[:cnt], fwd[:cnt].astype(bool)


def canonical_kmers(codes: np.ndarray, k: int):
    lib = get_lib()
    n = codes.size
    m = max(n - k + 1, 0)
    kmer = np.empty(m, np.uint64)
    valid = np.empty(m, np.uint8)
    fwd = np.empty(m, np.uint8)
    if m:
        lib.canonical_kmers(np.ascontiguousarray(codes), n, k, kmer, valid,
                            fwd)
    return kmer, fwd.astype(bool), valid.astype(bool)


def minimizers32_batch(mates, k: int, w: int):
    """One native call for a whole read batch.  Returns (read_ix, pos,
    hashes, fwd) concatenated over reads."""
    lib = get_lib()
    offsets = np.zeros(len(mates) + 1, np.int64)
    for i, m in enumerate(mates):
        offsets[i + 1] = offsets[i] + m.size
    flat = np.concatenate([np.ascontiguousarray(m) for m in mates])         if mates else np.empty(0, np.int8)
    cap = max(int(offsets[-1]), 1)
    read_ix = np.empty(cap, np.int64)
    pos = np.empty(cap, np.int64)
    hashes = np.empty(cap, np.uint32)
    fwd = np.empty(cap, np.uint8)
    cnt = lib.minimizers32_batch(flat, offsets, len(mates), k, w,
                                 read_ix, pos, hashes, fwd, cap)
    assert cnt >= 0
    return read_ix[:cnt], pos[:cnt], hashes[:cnt], fwd[:cnt].astype(bool)


def anchor_votes(read_ix, pos, hashes, fwd, rlens, idx_keys, idx_hap,
                 idx_pos, idx_fwd, k: int, bstep: int, min_votes: int,
                 max_per_hap: int):
    """Native anchor voting (model/locs.py candidates_batch_flat twin).
    Returns flat (read, hap, orient, diag) int64 arrays."""
    lib = get_lib()
    n_reads = rlens.size
    cap = max(int(read_ix.size) * 2, 1 << 12)
    fwd8 = np.ascontiguousarray(fwd, np.uint8)
    ifwd8 = np.ascontiguousarray(idx_fwd, np.uint8)
    while True:
        o_read = np.empty(cap, np.int64)
        o_hap = np.empty(cap, np.int64)
        o_orient = np.empty(cap, np.int64)
        o_diag = np.empty(cap, np.int64)
        n = lib.anchor_votes(
            np.ascontiguousarray(read_ix, np.int64),
            np.ascontiguousarray(pos, np.int64),
            np.ascontiguousarray(hashes, np.uint32), fwd8, read_ix.size,
            np.ascontiguousarray(rlens, np.int64), n_reads,
            np.ascontiguousarray(idx_keys, np.uint32),
            np.ascontiguousarray(idx_hap, np.int32),
            np.ascontiguousarray(idx_pos, np.int32), ifwd8, idx_keys.size,
            k, bstep, min_votes, max_per_hap,
            o_read, o_hap, o_orient, o_diag, cap)
        if n >= 0:
            return o_read[:n], o_hap[:n], o_orient[:n], o_diag[:n]
        cap *= 4


def count_unique_nonoverlap(codes: np.ndarray, k: int,
                            uniq_sorted: np.ndarray) -> int:
    """Native twin of UniqueKmers.count_read's inner loop."""
    lib = get_lib()
    return int(lib.count_unique_nonoverlap(
        np.ascontiguousarray(codes), codes.size, k,
        np.ascontiguousarray(uniq_sorted, np.uint64), uniq_sorted.size))


def count_unique_nonoverlap_batch(mates, k: int,
                                  uniq_sorted: np.ndarray) -> np.ndarray:
    """count_unique_nonoverlap over a whole read list in one native call."""
    lib = get_lib()
    offsets = np.zeros(len(mates) + 1, np.int64)
    for i, m in enumerate(mates):
        offsets[i + 1] = offsets[i] + m.size
    flat = (np.concatenate([np.ascontiguousarray(m) for m in mates])
            if mates else np.empty(0, np.int8))
    out = np.zeros(max(len(mates), 1), np.int64)
    lib.count_unique_nonoverlap_batch(
        flat, offsets, len(mates), k,
        np.ascontiguousarray(uniq_sorted, np.uint64), uniq_sorted.size, out)
    return out[:len(mates)]


def banded_align_cigar(query: np.ndarray, twin: np.ndarray, band: int,
                       score_vec: np.ndarray, max_cells: int = 1 << 28):
    """Native banded traceback alignment.  Returns (ops, lens, info, score)
    with ops coded 0 '=', 1 'X', 2 'I', 3 'D', 4 'S' and
    info = [start_p, end_p, n_mism, n_ins, n_del, n_clip]; None on failure
    (DP too large / op overflow)."""
    lib = get_lib()
    qlen = query.size
    max_ops = 2 * qlen + 16
    ops = np.empty(max_ops, np.int32)
    lens = np.empty(max_ops, np.int32)
    info = np.empty(6, np.int32)
    score = ctypes.c_float(0.0)
    n = lib.banded_align_cigar(
        np.ascontiguousarray(query), qlen, np.ascontiguousarray(twin),
        twin.size, band, np.ascontiguousarray(score_vec, np.float32),
        max_cells, ops, lens, max_ops, info, ctypes.byref(score))
    if n < 0:
        return None
    return ops[:n], lens[:n], info, float(score.value)


def kmer_fp_sorted(codes: np.ndarray, k: int):
    """Sorted 128-bit k-mer fingerprints (exact-match stand-in for the
    reference's U256 backbone k-mers).  Returns (pos, lo, hi) sorted by
    fingerprint."""
    lib = get_lib()
    n = codes.size
    m = max(n - k + 1, 1)
    pos = np.empty(m, np.uint32)
    lo = np.empty(m, np.uint64)
    hi = np.empty(m, np.uint64)
    cnt = lib.kmer_fp_sorted(np.ascontiguousarray(codes), n, k, pos, lo, hi)
    return pos[:cnt], lo[:cnt], hi[:cnt]


def kmer_match_join(codes1, fp1, codes2, fp2, k: int, cap: int = 1 << 22):
    """Exact k-mer matches between two sequences given their sorted
    fingerprints.  Returns (pos1, pos2) sorted lexicographically."""
    lib = get_lib()
    pos1, lo1, hi1 = fp1
    pos2, lo2, hi2 = fp2
    while True:
        o1 = np.empty(cap, np.uint32)
        o2 = np.empty(cap, np.uint32)
        n = lib.kmer_match_join(
            np.ascontiguousarray(codes1), pos1, lo1, hi1, pos1.size,
            np.ascontiguousarray(codes2), pos2, lo2, hi2, pos2.size,
            k, o1, o2, cap)
        if n >= 0:
            return o1[:n], o2[:n]
        cap *= 4


def chain_align(codes1, codes2, anchors1, anchors2, k: int, max_gap: int,
                mismatch: int, gap_open: int, gap_extend: int):
    """LCSk++ chain + smart gap fill over exact k-mer anchors.  Returns
    (ops, lens, score) where ops use the banded_align_cigar codes
    (0 '=', 1 'X', 2 'I', 3 'D')."""
    lib = get_lib()
    n1, n2 = codes1.size, codes2.size
    max_ops = 2 * (n1 + n2) + 16
    ops = np.empty(max_ops, np.int32)
    lens = np.empty(max_ops, np.int32)
    score = ctypes.c_int64(0)
    n = lib.chain_align(
        np.ascontiguousarray(codes1), n1, np.ascontiguousarray(codes2), n2,
        np.ascontiguousarray(anchors1, np.uint32),
        np.ascontiguousarray(anchors2, np.uint32), anchors1.size,
        k, max_gap, mismatch, gap_open, gap_extend,
        ops, lens, max_ops, ctypes.byref(score))
    assert n >= 0, "chain_align capacity exceeded"
    return ops[:n], lens[:n], int(score.value)


def parse_fastq_into(buf: np.ndarray, codes: np.ndarray, lens: np.ndarray,
                     name_off: np.ndarray, name_len: np.ndarray):
    """Parses the complete FASTQ records at the head of `buf` (uint8) into
    the rows of `codes` ([R, max_len] int8, C-contiguous: N-padded codes,
    clipped at max_len) and `lens` (int32), at most R records; record i's
    name (up to the first space, tab or newline) is buf[name_off[i]:
    name_off[i] + name_len[i]].  Returns (records, bytes_consumed,
    max_seen), where max_seen is the longest TRUE sequence length parsed:
    max_seen > max_len means a sequence was clipped and the caller must
    re-size (reference recruitment never clips, recruit.rs:852-932)."""
    lib = get_lib()
    rows, max_len = codes.shape
    if not (codes.flags.c_contiguous and lens.size >= rows
            and name_off.size >= rows and name_len.size >= rows):
        raise ValueError("parse_fastq_into: output arrays too small")
    consumed_c = ctypes.c_int64(0)
    max_seen_c = ctypes.c_int32(0)
    cnt = lib.parse_fastq(buf, buf.size, max_len, rows, codes.reshape(-1),
                          lens, name_off, name_len,
                          ctypes.byref(consumed_c),
                          ctypes.byref(max_seen_c))
    return int(cnt), int(consumed_c.value), int(max_seen_c.value)

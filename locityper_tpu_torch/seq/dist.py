"""Haplotype-haplotype chained alignment (counterpart of reference
seq/dist.rs + the gap-fill roles of seq/wfa.rs).

The reference aligns 10-500 kb haplotype pairs by matching exact
non-canonical k-mers for several backbone sizes (k in {25, 51, 101},
dist.rs:36-49), chaining each set with LCSk++ (dist.rs:204), filling
inter-anchor gaps with WFA gap-affine alignment (smart_align,
wfa.rs:259-304), and keeping the best-scoring k (dist.rs:245-271).

Here the hot path lives in native/kernels.cpp (`kmer_fp_sorted`,
`kmer_match_join`, `chain_align`); this module provides the orchestration,
a bit-compatible pure-Python fallback (also the parity oracle in
tests/test_dist.py), and the reference-format PAF row writer
(dist.rs:273-321).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .. import native
from ..ops.traceback import OP_CHARS
from .kmers import jaccard_distance, sorted_minimizer_set

BACKBONE_KS = (25, 51, 101)   # dist.rs:44
MAX_GAP = 500                 # dist.rs:46
DIV_K, DIV_W = 15, 15         # dist.rs:41-42
THRESH_DIV = 0.5              # dist.rs:43


@dataclass(frozen=True)
class Penalties:
    """WFA gap-affine penalties (wfa.rs:30-38)."""
    mismatch: int = 4
    gap_open: int = 6
    gap_extend: int = 1

    @property
    def safe_mismatch_size(self) -> int:
        # wfa.rs:192.
        return (2 * self.gap_open + 2 * self.gap_extend) // self.mismatch


# ---------------------------------------------------------------------------
# Pure-Python fallback (same algorithm; the oracle for the native kernels).
# ---------------------------------------------------------------------------

def _py_kmer_matches(codes1: np.ndarray, codes2: np.ndarray, k: int):
    """Exact k-mer (pos1, pos2) matches, sorted lexicographically
    (dist.rs get_kmer_matches)."""
    by_kmer: dict[bytes, list[int]] = {}
    b2 = codes2.tobytes()
    valid2 = np.flatnonzero(np.convolve((codes2 >= 4).astype(np.int32),
                                        np.ones(k, np.int32))[k - 1:codes2.size] == 0)
    for p in valid2:
        by_kmer.setdefault(b2[p:p + k], []).append(int(p))
    b1 = codes1.tobytes()
    valid1 = np.flatnonzero(np.convolve((codes1 >= 4).astype(np.int32),
                                        np.ones(k, np.int32))[k - 1:codes1.size] == 0)
    out1, out2 = [], []
    for p in valid1:
        hits = by_kmer.get(b1[p:p + k])
        if hits:
            for q in hits:
                out1.append(int(p))
                out2.append(q)
    return (np.asarray(out1, np.uint32), np.asarray(out2, np.uint32))


def _py_lcskpp(ap1: np.ndarray, ap2: np.ndarray, k: int) -> list[int]:
    """Event-sweep LCSk++ with a Fenwick max-tree — same recurrence as
    rust-bio sparse::lcskpp used at dist.rs:204."""
    n = ap1.size
    if n == 0:
        return []
    events = []
    for i in range(n):
        events.append((int(ap1[i]), int(ap2[i]), i + n))        # start
        events.append((int(ap1[i]) + k, int(ap2[i]) + k, i))    # end
    events.sort()
    max_n = max(max(int(ap1[i]) + k, int(ap2[i]) + k) for i in range(n)) + 2
    tree = [0] * (max_n + 2)

    def tset(i, packed):
        i += 1
        while i < len(tree):
            if packed > tree[i]:
                tree[i] = packed
            i += i & (-i)

    def tget(i):
        i += 1
        best = 0
        while i > 0:
            if tree[i] > best:
                best = tree[i]
            i -= i & (-i)
        return best

    # Sorted anchor list for the continuation binary search.
    pairs = [(int(ap1[i]), int(ap2[i])) for i in range(n)]
    import bisect
    dp_val = [0] * n
    dp_prev = [-1] * n
    best_val, best_idx = 0, 0
    for (x, y, code) in events:
        p = code % n
        j = y + 1
        if code >= n:
            dp_val[p] = k
            dp_prev[p] = -1
            packed = tget(j)
            value, idx = packed >> 32, packed & 0xFFFFFFFF
            if value > 0:
                dp_val[p] = k + value
                dp_prev[p] = idx
            if dp_val[p] > best_val:
                best_val, best_idx = dp_val[p], p
        else:
            if x > k and y > k:
                c = bisect.bisect_left(pairs, (x - k - 1, y - k - 1))
                if c < n and pairs[c] == (x - k - 1, y - k - 1):
                    if dp_val[c] + 1 > dp_val[p]:
                        dp_val[p] = dp_val[c] + 1
                        dp_prev[p] = c
                        if dp_val[p] > best_val:
                            best_val, best_idx = dp_val[p], p
            tset(j, (dp_val[p] << 32) | p)
    path = []
    q = best_idx
    while q >= 0:
        path.append(q)
        q = dp_prev[q]
    path.reverse()
    return path


class _Cig:
    def __init__(self):
        self.ops: list[int] = []
        self.lens: list[int] = []

    def push(self, op, ln):
        if ln <= 0:
            return
        if self.ops and self.ops[-1] == op:
            self.lens[-1] += ln
        else:
            self.ops.append(op)
            self.lens.append(ln)


def _py_align_simple(s1, s2, pen: Penalties, cig: _Cig) -> int:
    """wfa.rs:50-85: one leading INS/DEL then an =/X run."""
    a, b = s1.size, s2.size
    diff = a - b
    score = 0
    i = j = 0
    if diff < 0:
        cig.push(2, -diff)
        score = -pen.gap_open + diff * pen.gap_extend
        j = -diff
    elif diff > 0:
        cig.push(3, diff)
        score = -pen.gap_open - diff * pen.gap_extend
        i = diff
    eq = (s1[i:] == s2[j:]) & (s1[i:] < 4)
    ndiff = int((~eq).sum())
    # Push per-run.
    t = 0
    m = eq.size
    while t < m:
        e = t
        while e < m and eq[e] == eq[t]:
            e += 1
        cig.push(0 if eq[t] else 1, e - t)
        t = e
    return score - ndiff * pen.mismatch


def _py_gotoh(s1, s2, pen: Penalties, cig: _Cig) -> int:
    """Gotoh affine global DP (the WFA full-alignment branch)."""
    a, b = s1.size, s2.size
    NEG = -(1 << 30)
    mm, go, ge = pen.mismatch, pen.gap_open, pen.gap_extend
    M = np.full((a + 1, b + 1), NEG, np.int64)
    I = np.full((a + 1, b + 1), NEG, np.int64)
    D = np.full((a + 1, b + 1), NEG, np.int64)
    M[0, 0] = 0
    for j in range(1, b + 1):
        I[0, j] = -go - j * ge
    for i in range(1, a + 1):
        D[i, 0] = -go - i * ge
    for i in range(1, a + 1):
        sub = np.where((s1[i - 1] == s2) & (s1[i - 1] < 4), 0, -mm)
        for j in range(1, b + 1):
            M[i, j] = max(M[i - 1, j - 1], I[i - 1, j - 1],
                          D[i - 1, j - 1]) + sub[j - 1]
            I[i, j] = max(M[i, j - 1] - go - ge, I[i, j - 1] - ge)
            D[i, j] = max(M[i - 1, j] - go - ge, D[i - 1, j] - ge)
    i, j = a, b
    state = int(np.argmax([M[i, j], I[i, j], D[i, j]]))
    best = int([M[i, j], I[i, j], D[i, j]][state])
    rops = []
    while i > 0 or j > 0:
        if state == 0:
            rops.append(0 if (s1[i - 1] == s2[j - 1] and s1[i - 1] < 4) else 1)
            prev = max(M[i - 1, j - 1], I[i - 1, j - 1], D[i - 1, j - 1])
            state = int(np.argmax([M[i - 1, j - 1], I[i - 1, j - 1],
                                   D[i - 1, j - 1]]))
            assert prev > NEG
            i -= 1
            j -= 1
        elif state == 1:
            rops.append(2)
            state = 0 if M[i, j - 1] - pen.gap_open - pen.gap_extend >= \
                I[i, j - 1] - pen.gap_extend else 1
            j -= 1
        else:
            rops.append(3)
            state = 0 if M[i - 1, j] - pen.gap_open - pen.gap_extend >= \
                D[i - 1, j] - pen.gap_extend else 2
            i -= 1
    for op in reversed(rops):
        cig.push(op, 1)
    return best


def _py_smart_fill(c1, c2, i1, i2, j1, j2, max_gap, pen: Penalties,
                   cig: _Cig) -> int:
    jump1, jump2 = i2 - i1, j2 - j1
    if jump1 > 0 and jump2 > 0:
        if jump1 > max_gap or jump2 > max_gap:
            return _py_align_simple(c1[i1:i2], c2[j1:j2], pen, cig)
        if jump1 == jump2 and jump1 <= pen.safe_mismatch_size:
            eq = (c1[i1:i2] == c2[j1:j2]) & (c1[i1:i2] < 4)
            for v in eq:
                cig.push(0 if v else 1, 1)
            return -int((~eq).sum()) * pen.mismatch
        return _py_gotoh(c1[i1:i2], c2[j1:j2], pen, cig)
    if jump1 > 0:
        cig.push(3, jump1)
        return -pen.gap_open - jump1 * pen.gap_extend
    if jump2 > 0:
        cig.push(2, jump2)
        return -pen.gap_open - jump2 * pen.gap_extend
    return 0


def _py_chain_align(codes1, codes2, ap1, ap2, k, max_gap, pen: Penalties):
    """dist.rs align():184-243 walk over the LCSk++ chain."""
    path = _py_lcskpp(ap1, ap2, k)
    cig = _Cig()
    score = 0
    i1 = j1 = curr = 0
    for ix in path:
        i2, j2 = int(ap1[ix]), int(ap2[ix])
        if i1 > i2:
            curr += 1
            i1 += 1
            j1 += 1
            continue
        if curr:
            cig.push(0, curr)
            curr = 0
        score += _py_smart_fill(codes1, codes2, i1, i2, j1, j2, max_gap, pen,
                                cig)
        curr = k
        i1, j1 = i2 + k, j2 + k
    if curr:
        cig.push(0, curr)
    score += _py_smart_fill(codes1, codes2, i1, codes1.size, j1, codes2.size,
                            max_gap, pen, cig)
    return (np.asarray(cig.ops, np.int32), np.asarray(cig.lens, np.int32),
            score)


# ---------------------------------------------------------------------------
# Public aligner.
# ---------------------------------------------------------------------------

class PairAligner:
    """Best-of-k chained global aligner for haplotype pairs
    (dist.rs align_multik:245-271)."""

    def __init__(self, ks=BACKBONE_KS, max_gap=MAX_GAP,
                 penalties: Penalties | None = None, use_native=None):
        self.ks = tuple(ks)
        self.max_gap = int(max_gap)
        self.pen = penalties or Penalties()
        self.native = native.available() if use_native is None else use_native

    def fingerprints(self, codes: np.ndarray):
        """Per-sequence cache entry for `align`; one entry per backbone k."""
        codes = np.ascontiguousarray(codes, np.int8)
        if self.native:
            return {k: native.kmer_fp_sorted(codes, k) for k in self.ks}
        return None  # fallback matches directly from the sequences

    def align(self, codes1: np.ndarray, codes2: np.ndarray, fps1=None,
              fps2=None):
        """Global alignment of codes1 (ref/target) vs codes2 (query).
        Returns (ops, lens, score): run-length extended CIGAR with ops
        0 '=', 1 'X', 2 'I' (consumes codes2), 3 'D' (consumes codes1),
        covering both sequences end-to-end."""
        codes1 = np.ascontiguousarray(codes1, np.int8)
        codes2 = np.ascontiguousarray(codes2, np.int8)
        best = None
        for k in self.ks:
            if self.native:
                f1 = fps1[k] if fps1 else native.kmer_fp_sorted(codes1, k)
                f2 = fps2[k] if fps2 else native.kmer_fp_sorted(codes2, k)
                ap1, ap2 = native.kmer_match_join(codes1, f1, codes2, f2, k)
                ops, lens, score = native.chain_align(
                    codes1, codes2, ap1, ap2, k, self.max_gap,
                    self.pen.mismatch, self.pen.gap_open,
                    self.pen.gap_extend)
            else:
                ap1, ap2 = _py_kmer_matches(codes1, codes2, k)
                ops, lens, score = _py_chain_align(
                    codes1, codes2, ap1, ap2, k, self.max_gap, self.pen)
            if best is None or score > best[2]:
                best = (ops, lens, score)
        assert best is not None
        _check_cigar_cover(best[0], best[1], codes1.size, codes2.size)
        return best


def _check_cigar_cover(ops, lens, n1, n2):
    """dist.rs:238-241 invariant: the CIGAR covers both sequences."""
    ref_len = int(lens[(ops == 0) | (ops == 1) | (ops == 3)].sum())
    query_len = int(lens[(ops == 0) | (ops == 1) | (ops == 2)].sum())
    assert ref_len == n1 and query_len == n2, \
        f"chained CIGAR covers {ref_len}/{n1} ref, {query_len}/{n2} query"


def cigar_stats(ops: np.ndarray, lens: np.ndarray):
    """(matches, errors) per dist.rs:295-302: '=' vs everything else."""
    matches = int(lens[ops == 0].sum())
    nerrs = int(lens[ops != 0].sum())
    return matches, nerrs


def paf_row(name1: str, codes1: np.ndarray, name2: str, codes2: np.ndarray,
            aln=None, div=None) -> str:
    """Reference-format PAF row (dist.rs process_pair:273-321):
    query = entry2, target = entry1, both full-length; with alignment tags
    NM/AS/dv/qv and cg, plus um/md minimizer-divergence tags.  `aln` is the
    (ops, lens, score) triple or None for a skipped pair; `div` the
    (unique_minimizers, divergence) pair or None."""
    n1, n2 = codes1.size, codes2.size
    parts = [name2, str(n2), "0", str(n2), "+", name1, str(n1), "0", str(n1)]
    cg = ""
    if aln is not None:
        ops, lens, score = aln
        matches, nerrs = cigar_stats(ops, lens)
        aln_len = matches + nerrs
        dv = nerrs / aln_len if aln_len else 0.0
        qv = -10.0 * math.log10(dv) if dv > 0 else float("inf")
        parts += [str(matches), str(aln_len), "255",
                  f"NM:i:{nerrs}", f"AS:i:{score}", f"dv:f:{dv:.9f}",
                  f"qv:f:{qv:.6f}"]
        cg = "".join(f"{int(l)}{OP_CHARS[int(o)]}" for o, l in zip(ops, lens))
    else:
        parts += ["0", "0", "255"]
    if div is not None:
        parts += [f"um:i:{div[0]}", f"md:f:{div[1]:.9f}"]
    if cg:
        parts.append(f"cg:Z:{cg}")
    return "\t".join(parts)


def minimizer_divergence(codes1, codes2, k=DIV_K, w=DIV_W):
    """(unique minimizers, Jaccard divergence) for the um/md tags and the
    thresh_div gate (div.rs:16-40)."""
    s1 = sorted_minimizer_set(codes1, k, w)
    s2 = sorted_minimizer_set(codes2, k, w)
    return jaccard_distance(s1, s2)

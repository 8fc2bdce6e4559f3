"""Linguistic complexity: fraction of distinct k-mers in moving windows.

Counterpart of reference seq/compl.rs:115-140 (`linguistic_complexity`):
for window size w and k-mer size k (default 5), complexity at window start i
is  #distinct(kmers[i .. i+w-k+1]) / min(w-k+1, 4^k).

The reference uses an O(n) rolling hash-map update.  Here a locus's
haplotypes go through one vectorised pass (`distinct_kmer_counts`): the
forward k-mer codes of all of them at once, each k-mer's previous occurrence
in its own haplotype by one stable sort of the codes, and the windows'
distinct counts as a cumulative sum of +1/-1 differences.  The complexity
is those counts times `complexity_scale`.
"""
from __future__ import annotations

import numpy as np

from .dna import encode


def _code_dtype(k: int):
    """The narrowest unsigned type that holds a 2k-bit code; codes of k > 32
    wrap modulo 2^64, as the reference's uint64 k-mers do."""
    bits = 2 * k
    return (np.uint16 if bits <= 16 else np.uint32 if bits <= 32
            else np.uint64)


def complexity_scale(k: int, w: int) -> float:
    """What a window's distinct count is multiplied by (w >= k)."""
    return 1.0 / min(w - k + 1, 1 << (2 * k))


def distinct_kmer_counts(seqs, k: int, w: int):
    """Distinct valid k-mers of every window start 0..n-w of every sequence
    of `seqs` (code arrays or strings), as (counts, offsets): sequence h's
    int64 counts are counts[offsets[h]:offsets[h + 1]], none where the
    sequence holds fewer than w - k + 1 k-mers.  A k-mer with an invalid
    base (N) is counted in no window but still marks its code (N read as A)
    as seen, as the one-sequence version always did."""
    codes = [s if isinstance(s, np.ndarray) else encode(s) for s in seqs]
    n = np.fromiter((c.size for c in codes), np.int64, len(codes))
    win = w - k + 1
    n_out = np.maximum(n - w + 1, 0) if win > 0 else np.zeros_like(n)
    offsets = np.zeros(n.size + 1, np.int64)
    np.cumsum(n_out, out=offsets[1:])
    live = np.nonzero(n_out)[0]
    if live.size == 0:
        return np.empty(0, np.int64), offsets

    # The live sequences end to end: every base starts one k-mer, an N read
    # as A; a k-mer that holds an N is counted in no window.
    flat = np.concatenate([codes[h] for h in live])
    n_live = n[live]
    start = np.zeros(live.size, np.int64)
    np.cumsum(n_live[:-1], out=start[1:])
    N = flat.size
    valid_base = np.zeros(N + k - 1, bool)
    valid_base[:N] = flat < 4
    dt = _code_dtype(k)
    c = np.zeros(N + k - 1, dt)
    np.copyto(c[:N], flat, where=valid_base[:N], casting="unsafe")
    fw = c[:N].copy()
    valid = valid_base[:N].copy()
    for j in range(1, k):
        fw <<= dt(2)
        fw |= c[j:j + N]
        valid &= valid_base[j:j + N]

    # Position i counts in the windows that start in (max(prev, i - win), i],
    # prev being the last position before i with its code: a +1 at the
    # first of them and a -1 at i + 1, whose cumulative sum is the distinct
    # counts.  The stable sort keeps equal codes in position order, so prev
    # is the neighbour before i in sorted order.  No sequence boundary needs
    # a test: a prev in the sequence before only moves a +1 within the gap
    # between that sequence's last window and this one's first, which acts
    # as a start clipped to this one's first; a k-mer that runs into the
    # next sequence puts its +1 past its own sequence's last window and its
    # -1 no later than the next one's first, where the two cancel.
    order = np.argsort(fw, kind="stable")
    sk = fw[order]
    lo = order - (win - 1)
    same = np.empty(N, bool)
    same[0] = False
    np.equal(sk[1:], sk[:-1], out=same[1:])
    prev1 = np.zeros(N, np.int64)
    prev1[1:] = order[:-1] + 1
    np.maximum(lo, prev1, out=lo, where=same)
    np.maximum(lo, 0, out=lo)
    diff = np.bincount(lo[valid[order]], minlength=N + 1)
    diff[1:] -= valid
    counts = np.cumsum(diff[:N])
    # Window i of live sequence r is position start_r + i; sequences with no
    # window take no room in `values`.
    windows = np.zeros(N, bool)
    for s, m in zip(start, n_out[live]):
        windows[s:s + m] = True
    return counts[windows], offsets


def linguistic_complexity(seq, k: int, w: int) -> np.ndarray:
    """Complexity for every window start 0..n-w (inclusive) of one sequence;
    windows containing invalid bases get the distinct-count over valid
    k-mers only (the reference panics on Ns; our inputs may include them,
    so we degrade gracefully)."""
    counts, _ = distinct_kmer_counts([seq], k, w)
    if counts.size == 0:
        return np.empty(0, np.float64)
    return counts * complexity_scale(k, w)

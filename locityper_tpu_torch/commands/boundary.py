"""Locus boundary expansion: move locus edges to variant-free,
unique-k-mer-rich positions.

Counterpart of reference command/add.rs find_best_boundary (:330-394) and
expand_locus (:397-477):

* per candidate boundary position, weight = fraction of unique (count ≤ 1)
  k-mers in the `moving_window` starting there;
* positions inside variants get weight 0; positions within 9 bp of a
  variant are down-weighted linearly;
* distance from the original boundary costs up to 20% linearly over the
  allowed expansion;
* LEFT boundary takes the LAST argmax (prefer closer to the locus), RIGHT
  takes the FIRST.
"""
from __future__ import annotations

import numpy as np

EFFECT_MARGIN = 9
WEIGHT_DROP = 0.2
DEFAULT_MOVING_WINDOW = 500
DEFAULT_MAX_EXPANSION = 20_000


def find_best_boundary(left: bool, start: int, end: int, variants,
                       k: int, kmer_counts: np.ndarray,
                       allowed_expansion: int,
                       moving_window: int = DEFAULT_MOVING_WINDOW):
    """Best boundary in [start, end); `variants` = [(var_start, var_end)]
    absolute.  kmer_counts: genome-wide counts for k-mers of the region
    [start, end + moving_window - 1).  Returns position or None."""
    if start == end:
        for vs, ve in variants:
            if vs <= start and end <= ve:
                return None
        return start

    uniq = (kmer_counts <= 1).astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(uniq)])
    kmers_per_window = moving_window + 1 - k
    n = end - start
    weights = (cum[kmers_per_window:kmers_per_window + n] - cum[:n]) \
        / float(kmers_per_window)
    assert weights.size == n

    eff_div = float(EFFECT_MARGIN + 1)
    for vs, ve in variants:
        lo = max(vs - start, 0)
        hi = max(min(ve, end) - start, 0)
        weights[lo:hi] = 0.0
        # Downweight approach from the left of the variant start.
        for i in range(max(vs - end, 0), min(max(vs - start, 0), EFFECT_MARGIN)):
            weights[vs - start - i - 1] *= (EFFECT_MARGIN - i) / eff_div
        # Downweight positions right after the variant end.
        for i in range(max(start - ve, 0), min(end - ve, EFFECT_MARGIN)):
            if 0 <= ve + i - start < n:
                weights[ve + i - start] *= (i + 1) / eff_div

    per_bp_drop = WEIGHT_DROP / float(max(allowed_expansion, 1))
    if left:
        # Distance penalty grows away from the inner start (rightmost = 0).
        dist = np.arange(n - 1, -1, -1)
        weights = weights * (1.0 - per_bp_drop * dist)
        best = float(np.max(weights))
        if best <= 0.0:
            return None
        # Last argmax.
        i = n - 1 - int(np.argmax(weights[::-1]))
    else:
        dist = np.arange(n)
        weights = weights * (1.0 - per_bp_drop * dist)
        best = float(np.max(weights))
        if best <= 0.0:
            return None
        i = int(np.argmax(weights))
    return start + i


def expand_locus(chrom_seq: np.ndarray, inner_start: int, inner_end: int,
                 genome_counter, variants=(),
                 allowed_expansion: int = DEFAULT_MAX_EXPANSION,
                 moving_window: int = DEFAULT_MOVING_WINDOW):
    """Returns (new_start, new_end) or None if no valid boundary exists.

    variants: [(start, end)] absolute positions of variants near the locus
    edges (empty when building from FASTA haplotypes).
    """
    contig_len = chrom_seq.size
    assert inner_end - inner_start >= moving_window, "Locus shorter than window"
    k = genome_counter.k

    left_start = max(inner_start - allowed_expansion, 0)
    left_end = inner_start + moving_window
    left_seq = chrom_seq[left_start:left_end]
    # Crop at the last N.
    ns = np.nonzero(left_seq >= 4)[0]
    if ns.size:
        shift = int(ns[-1]) + 1
        left_start += shift
        if left_start > inner_start:
            return None
        left_seq = left_seq[shift:]

    right_start = inner_end - moving_window
    right_end = min(inner_end + allowed_expansion, contig_len)
    right_seq = chrom_seq[right_start:right_end]
    ns = np.nonzero(right_seq >= 4)[0]
    if ns.size:
        right_end = right_start + int(ns[0])
        if right_end < inner_end:
            return None
        right_seq = right_seq[:int(ns[0])]

    left_counts = genome_counter.seq_counts(left_seq)
    right_counts = genome_counter.seq_counts(right_seq)
    left_vars = [(vs, ve) for vs, ve in variants if ve > left_start and vs <= inner_start]
    right_vars = [(vs, ve) for vs, ve in variants if ve >= inner_end - 1 and vs < right_end]

    new_start = find_best_boundary(True, left_start, inner_start + 1,
                                   left_vars, k, left_counts,
                                   allowed_expansion, moving_window)
    if new_start is None:
        return None
    # Right-side counts start moving_window-1 before the search start, so
    # each weight's window ENDS at its boundary position (add.rs:419-424).
    new_end = find_best_boundary(False, inner_end - 1, right_end,
                                 right_vars, k, right_counts,
                                 allowed_expansion, moving_window)
    if new_end is None:
        return None
    return new_start, new_end + 1

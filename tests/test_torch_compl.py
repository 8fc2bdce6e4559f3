"""A locus's neighbourhood profile (`model/windows.py:NeighbProfile`, over
`seq/compl.py:distinct_kmer_counts`) against the JAX package's
one-haplotype functions, `seq.compl.linguistic_complexity` and
`model.windows.ContigInfo.new`, bit for bit.

One locus of haplotypes of unequal length, with runs of N, one haplotype all
N and one low-complexity repeat; the complexity also on haplotypes shorter
than a neighbourhood (no window) and of fewer bases than k.  k 3 and 5 give
16-bit codes, 9 a 32-bit code and 17 a 64-bit one.
"""
import numpy as np
import pytest

from locityper_tpu.model import Params as JParams
from locityper_tpu.model.windows import ContigInfo as JContigInfo
from locityper_tpu.model.windows import ExplicitWeights as JExplicitWeights
from locityper_tpu.seq.compl import linguistic_complexity as j_compl
from locityper_tpu_torch.model import Params
from locityper_tpu_torch.model.windows import (ExplicitWeights,
                                               NeighbProfile,
                                               build_contig_infos)
from locityper_tpu_torch.seq.compl import (complexity_scale,
                                           distinct_kmer_counts,
                                           linguistic_complexity)
from locityper_tpu_torch.seq.contigs import ContigSet
from locityper_tpu_torch.seq.counts import KmerCounts
from locityper_tpu_torch.utils import spans

KS = [5, 3, 9, 17]
NEIGHBS = [100, 300]
COUNTS_K = 25


def locus_haplotypes(rng, n_haps=9):
    """Haplotypes of 520-1,400 bases: one all N, one a repeat of 3 bases,
    the others random with up to two runs of N."""
    seqs = []
    for h in range(n_haps):
        n = int(rng.integers(520, 1400))
        if h == 3:
            seqs.append(np.full(n, 4, np.int8))
            continue
        if h == 5:
            seqs.append(np.resize(rng.integers(0, 4, 3).astype(np.int8), n))
            continue
        s = rng.integers(0, 4, n).astype(np.int8)
        for _ in range(h % 3):
            a = int(rng.integers(0, n - 40))
            s[a:a + int(rng.integers(1, 40))] = 4
        seqs.append(s)
    return seqs


def make_profile(seed, k, explicit):
    rng = np.random.default_rng(seed)
    seqs = locus_haplotypes(rng)
    names = [f"hap{h}" for h in range(len(seqs))]
    counts = [rng.integers(0, 3, s.size - COUNTS_K + 1).astype(np.uint16)
              for s in seqs]
    intervals = ({names[h]: [(50, 400, 0.5), (300, 700, 0.25)]
                  for h in range(0, len(seqs), 2)} if explicit else None)
    return seqs, names, counts, intervals, Params(complexity_k=k)


@pytest.mark.parametrize("neighb", NEIGHBS)
@pytest.mark.parametrize("k", KS)
def test_complexity_rows_equal_one_haplotype_at_a_time(k, neighb):
    rng = np.random.default_rng(7 * k + neighb)
    seqs = locus_haplotypes(rng)
    # Shorter than a neighbourhood, exactly one window, fewer bases than k.
    seqs[1] = seqs[1][:neighb - 1]
    seqs[2] = seqs[2][:neighb]
    seqs.append(rng.integers(0, 4, k - 1).astype(np.int8))
    counts, offsets = distinct_kmer_counts(seqs, k, neighb)
    assert counts.dtype == np.int64 and offsets[-1] == counts.size
    for h, s in enumerate(seqs):
        want = j_compl(s, k, neighb)
        got = counts[offsets[h]:offsets[h + 1]] * complexity_scale(k, neighb)
        assert got.dtype == want.dtype and np.array_equal(got, want), h
        assert np.array_equal(linguistic_complexity(s, k, neighb), want)
    assert offsets[2] == offsets[1]          # no window
    assert offsets[3] - offsets[2] == 1


def test_complexity_of_a_window_shorter_than_k_is_empty():
    seqs = [np.zeros(50, np.int8), np.arange(60, dtype=np.int8) % 4]
    counts, offsets = distinct_kmer_counts(seqs, 9, 8)
    assert counts.size == 0 and offsets.tolist() == [0, 0, 0]
    assert j_compl(seqs[1], 9, 8).size == 0
    assert np.array_equal(linguistic_complexity("ACGTNACGTACGGT", 3, 6),
                          j_compl("ACGTNACGTACGGT", 3, 6))


@pytest.mark.parametrize("explicit", [False, True],
                         ids=["plain", "explicit"])
@pytest.mark.parametrize("neighb", NEIGHBS)
@pytest.mark.parametrize("k", KS)
def test_profile_equals_contig_info_new(k, neighb, explicit):
    seqs, names, counts, intervals, params = make_profile(
        11 * k + neighb, k, explicit)
    window = 100
    profile = NeighbProfile(ContigSet("L", names, seqs),
                            KmerCounts(COUNTS_K, counts), neighb, params)
    with spans.call("genotype") as root:
        compl = profile.compl
        infos = profile.contig_infos(
            window, ExplicitWeights(intervals) if explicit else None)
    assert root.attrs == {"compl_haps": len(seqs)}   # one pass
    j_params = JParams(complexity_k=k)
    j_explicit = JExplicitWeights(intervals) if explicit else None
    for h, (s, c, info) in enumerate(zip(seqs, counts, infos)):
        assert np.array_equal(compl[h], j_compl(s, k, neighb),
                              equal_nan=True), h
        want = JContigInfo.new(s, c, COUNTS_K, window, neighb, j_params,
                               explicit=j_explicit, contig_name=names[h])
        for field in ("contig_len", "n_windows", "reg_start", "window_size",
                      "neighb_size", "left_padding"):
            assert getattr(info, field) == getattr(want, field), (h, field)
        assert info.gc_at.dtype == want.gc_at.dtype == np.uint8
        assert info.weight_at.dtype == want.weight_at.dtype == np.float32
        assert np.array_equal(info.gc_at, want.gc_at), h
        assert np.array_equal(info.weight_at, want.weight_at,
                              equal_nan=True), h
    again = build_contig_infos(ContigSet("L", names, seqs),
                               KmerCounts(COUNTS_K, counts), window, neighb,
                               params,
                               ExplicitWeights(intervals) if explicit
                               else None)
    for a, b in zip(again, infos):
        assert np.array_equal(a.weight_at, b.weight_at)


def test_a_contig_shorter_than_its_neighbourhood_is_refused():
    seqs, names, counts, _, params = make_profile(3, 5, False)
    profile = NeighbProfile(ContigSet("L", names, seqs),
                            KmerCounts(COUNTS_K, counts), 1000, params)
    assert profile.compl[0].size == max(seqs[0].size - 999, 0)
    with pytest.raises(AssertionError):
        profile.contig_infos(100)

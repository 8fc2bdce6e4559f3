"""Per-haplotype window characteristics as dense position arrays.

Counterpart of reference model/windows.rs (ContigInfo :343-424,
WeightCalculator :153-190, GenotypeWindows :710-806), restructured so that
everything the solver needs is a flat array gatherable on device:

* `gc_at[p]`    — GC bin (0..=100) of the neighbourhood whose window starts
  at position p (already shifted by the left padding, windows.rs:439-445);
* `weight_at[p]`— window weight = kmer-sigmoid × complexity-sigmoid
  (explicit BED weights multiply in when provided);
* the regular window grid (n_windows, reg_start, window_size) per contig.

Random window tweaks (assgn.rs:127-151, windows.rs:478-486) then become
device-side index arithmetic: a tweaked window start indexes `gc_at` /
`weight_at` directly.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..seq.compl import complexity_scale, distinct_kmer_counts
from ..seq.contigs import ContigSet
from ..seq.counts import KmerCounts
from ..utils import spans
from . import Params

UNMAPPED_WINDOW = 0
BOUNDARY_WINDOW = 1
REG_WINDOW_SHIFT = 2


def weight_calc(x: np.ndarray, breakpoint: float, power: float) -> np.ndarray:
    """Sigmoid weight: 1 / (1 + cf·((1−x)/x)^power), weight(bp) = 1/2
    (windows.rs:162-190)."""
    cf = (breakpoint / (1.0 - breakpoint)) ** power
    x = np.clip(np.asarray(x, dtype=np.float64), 1e-12, 1.0)
    ratio = np.clip((1.0 - x) / x, 0.0, None)
    return 1.0 / (1.0 + cf * np.power(ratio, power))


@dataclass
class ContigInfo:
    contig_len: int
    n_windows: int
    reg_start: int
    window_size: int
    neighb_size: int
    left_padding: int
    gc_at: np.ndarray          # uint8 [contig_len], indexed by window start
    weight_at: np.ndarray      # f32   [contig_len]

    def default_window_starts(self) -> np.ndarray:
        return self.reg_start + self.window_size * np.arange(self.n_windows)

    def window_of_middle(self, middles: np.ndarray) -> np.ndarray:
        """Static-grid window index per middle, BOUNDARY if outside, UNMAPPED
        for middle < 0 (windows.rs:465-470; shift added by the caller)."""
        middles = np.asarray(middles)
        w = (middles - self.reg_start) // self.window_size
        inside = (middles >= self.reg_start) & (w >= 0) & (w < self.n_windows)
        out = np.where(inside, w + REG_WINDOW_SHIFT, BOUNDARY_WINDOW)
        return np.where(middles < 0, UNMAPPED_WINDOW, out)


class ExplicitWeights:
    """Per-bp weights from a BED-like file `contig  start  end  weight`
    (reference ExplicitWeights, model/windows.rs:193-317; the reference
    stores u64 fixed-point cumsums — plain f64 cumsums here).  Positions not
    covered default to 1.0; overlapping intervals multiply."""

    def __init__(self, intervals: dict[str, list]):
        self.intervals = intervals       # name -> [(start, end, weight)]

    @classmethod
    def load(cls, path) -> "ExplicitWeights":
        from ..utils.io import smart_open
        out: dict[str, list] = {}
        with smart_open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith(("#", "track")):
                    continue
                cols = line.split()
                if len(cols) < 4:
                    raise ValueError(
                        f"{path}: weights BED needs 4 columns "
                        f"(contig start end weight), got {line!r}")
                w = float(cols[3])
                if not 0.0 <= w <= 1.0:
                    raise ValueError(
                        f"{path}: weight {w} out of [0, 1] on line {line!r}")
                out.setdefault(cols[0], []).append(
                    (int(cols[1]), int(cols[2]), w))
        return cls(out)

    def per_bp(self, name: str, length: int) -> np.ndarray:
        w = np.ones(length, np.float64)
        for start, end, weight in self.intervals.get(name, ()):
            w[max(start, 0):min(end, length)] *= weight
        return w


class NeighbProfile:
    """A locus's neighbourhood profile (windows.rs:387-407): for every
    haplotype and every start of a neighbourhood of `neighb_size` bases, its
    linguistic complexity, GC bin, unique-k-mer fraction and the product of
    the k-mer and complexity sigmoid weights.

    Built on first use, in one pass over all the locus's haplotypes end to
    end (counted as `compl_haps` in the open call).  A `genotype` call makes
    one a locus and hands it to post-alignment (`compl`, the short-read
    edit-threshold relaxation) and to the solver's inputs (`contig_infos`),
    so that the pass runs once a call; nothing outlives the call.  Arrays
    are flat over the haplotypes: haplotype h holds the neighbourhood starts
    pos_offsets[h]:pos_offsets[h + 1], max(len - neighb_size + 1, 0) of them.
    """

    def __init__(self, contig_set: ContigSet, kmer_counts: KmerCounts,
                 neighb_size: int, params: Params):
        self.contig_set = contig_set
        self.kmer_counts = kmer_counts
        self.neighb_size = neighb_size
        self.params = params
        self._built = False

    def _build(self) -> None:
        if self._built:
            return
        seqs, neighb, params = (self.contig_set.seqs, self.neighb_size,
                                self.params)
        spans.count("compl_haps", len(seqs))
        self.lens = n = np.fromiter((s.size for s in seqs), np.int64,
                                    len(seqs))
        n_pos = np.maximum(n - neighb + 1, 0)
        self.pos_offsets = np.zeros(n.size + 1, np.int64)
        np.cumsum(n_pos, out=self.pos_offsets[1:])
        # Each weight and GC bin is a function of an integer count in a
        # neighbourhood: computed once for every possible count, then
        # looked up (the same arithmetic on the same values).

        # Linguistic complexity (:404-407).
        k = params.complexity_k
        counts, self.compl_offsets = distinct_kmer_counts(seqs, k, neighb)
        if neighb >= k:
            scale = complexity_scale(k, neighb)
            self.compl_values = counts * scale
            compl_w = weight_calc(np.arange(neighb - k + 2) * scale,
                                  params.compl_weight_breakpoint,
                                  params.compl_weight_power)[counts]
        else:       # no window: a missing complexity reads as 1
            self.compl_values = np.empty(0, np.float64)
            compl_w = np.repeat(weight_calc(np.ones(1),
                                            params.compl_weight_breakpoint,
                                            params.compl_weight_power),
                                self.pos_offsets[-1])

        # GC% over every neighbourhood (windows.rs:387-391).
        base = np.zeros(n.size + 1, np.int64)
        np.cumsum(n, out=base[1:])
        at = self._pos_index(base[:-1], n_pos)
        bases = np.concatenate(seqs)
        cum = np.zeros(bases.size + 1, np.int64)
        np.cumsum((bases == 1) | (bases == 2), out=cum[1:])
        gc_bin = np.round(100.0 * np.arange(neighb + 1) / neighb)
        self.gc = gc_bin.astype(np.uint8)[cum[at + neighb] - cum[at]]

        # Unique k-mer fraction (count == 0) per neighbourhood (:393-403).
        kmer_counts = self.kmer_counts.counts
        span = neighb + 1 - self.kmer_counts.k
        n_cnt = np.fromiter((c.size for c in kmer_counts), np.int64,
                            len(kmer_counts))
        nk = np.minimum(span, n_cnt)
        if np.any((nk + n_pos > n_cnt + 1) & (n_pos > 0)):
            raise ValueError("k-mer counts shorter than their haplotype")
        cnt_start = np.zeros(n.size + 1, np.int64)
        np.cumsum(n_cnt, out=cnt_start[1:])
        at = self._pos_index(cnt_start[:-1], n_pos)
        cumu = np.zeros(cnt_start[-1] + 1, np.int64)
        np.cumsum(np.concatenate(kmer_counts) == 0, out=cumu[1:])
        uniq_w = weight_calc(np.arange(span + 1) / span,
                             params.kmers_weight_breakpoint,
                             params.kmers_weight_power)
        self.weight = uniq_w[cumu[at + np.repeat(nk, n_pos)] - cumu[at]] \
            * compl_w
        self._built = True

    def _pos_index(self, first: np.ndarray, n_pos: np.ndarray) -> np.ndarray:
        """For every neighbourhood start of every haplotype, `first` of its
        haplotype plus the start."""
        return np.arange(self.pos_offsets[-1], dtype=np.int64) + np.repeat(
            first - self.pos_offsets[:-1], n_pos)

    @property
    def compl(self) -> list[np.ndarray]:
        """Each haplotype's moving-window complexity, empty where it is
        shorter than a neighbourhood."""
        self._build()
        o = self.compl_offsets
        return [self.compl_values[o[h]:o[h + 1]] for h in range(o.size - 1)]

    def contig_infos(self, window_size: int,
                     explicit: "ExplicitWeights | None" = None
                     ) -> list[ContigInfo]:
        """Each haplotype's `ContigInfo` (windows.rs:343-424), the mean
        explicit weight of each neighbourhood multiplied in when `explicit`
        is given (windows.rs:439-445)."""
        self._build()
        neighb, boundary = self.neighb_size, self.params.boundary_size
        n, po = self.lens, self.pos_offsets
        n_pos = np.diff(po)
        for contig_len, m in zip(n, n_pos):
            assert contig_len >= window_size + 2 * boundary, \
                f"Contig too short ({contig_len})"
            assert m >= 1, \
                f"Contig shorter than its neighbourhood ({contig_len})"
        w = self.weight
        if explicit is not None:
            mean_e = []
            for name, contig_len, m in zip(self.contig_set.contigs.names, n,
                                           n_pos):
                cume = np.concatenate([[0.0], np.cumsum(
                    explicit.per_bp(name, int(contig_len)))])
                mean_e.append((cume[neighb:] - cume[:-neighb])[:m] / neighb)
            w = w * np.concatenate(mean_e)
        # Per-window-start indexing: neighb_info(start) reads
        # mov_info[max(start - left_padding, 0)] (windows.rs:439-445).
        left_padding = (neighb - window_size) // 2
        base = np.zeros(n.size + 1, np.int64)
        np.cumsum(n, out=base[1:])
        first = np.repeat(base[:-1], n)
        at = np.arange(base[-1], dtype=np.int64) - first - left_padding
        np.clip(at, 0, np.repeat(n_pos - 1, n), out=at)
        at += np.repeat(po[:-1], n)
        gc_at, weight_at = self.gc[at], w[at].astype(np.float32)
        infos = []
        for h, contig_len in enumerate(n.tolist()):
            n_windows = (contig_len - 2 * boundary) // window_size
            reg_start = (contig_len - n_windows * window_size) // 2
            infos.append(ContigInfo(
                contig_len, n_windows, reg_start, window_size, neighb,
                left_padding, gc_at=gc_at[base[h]:base[h + 1]],
                weight_at=weight_at[base[h]:base[h + 1]]))
        return infos


def build_contig_infos(contig_set: ContigSet, kmer_counts: KmerCounts,
                       window_size: int, neighb_size: int, params: Params,
                       explicit: ExplicitWeights | None = None) -> list[ContigInfo]:
    return NeighbProfile(contig_set, kmer_counts, neighb_size,
                         params).contig_infos(window_size, explicit)


@dataclass
class ContigInfoPack:
    """Dense [H, ...] stacking of per-contig arrays for device gathers."""
    n_haps: int
    max_len: int
    max_windows: int
    n_windows: np.ndarray      # [H] int32
    reg_start: np.ndarray      # [H] int32
    contig_len: np.ndarray     # [H] int32
    window_size: int
    gc_at: np.ndarray          # [H, max_len] int32
    weight_at: np.ndarray      # [H, max_len] f32

    @classmethod
    def pack(cls, infos: list[ContigInfo]) -> "ContigInfoPack":
        H = len(infos)
        # Bucket shapes (len to 1024-multiples, windows to 32-multiples) so
        # solver compiles are shared across loci of similar size.
        max_len = -(-max(ci.contig_len for ci in infos) // 1024) * 1024
        gc = np.zeros((H, max_len), np.int32)
        wt = np.zeros((H, max_len), np.float32)
        for h, ci in enumerate(infos):
            gc[h, :ci.contig_len] = ci.gc_at
            wt[h, :ci.contig_len] = ci.weight_at
        return cls(
            n_haps=H, max_len=max_len,
            max_windows=-(-max(ci.n_windows for ci in infos) // 32) * 32,
            n_windows=np.array([ci.n_windows for ci in infos], np.int32),
            reg_start=np.array([ci.reg_start for ci in infos], np.int32),
            contig_len=np.array([ci.contig_len for ci in infos], np.int32),
            window_size=infos[0].window_size,
            gc_at=gc, weight_at=wt)

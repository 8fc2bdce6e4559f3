"""Read × haplotype alignment likelihoods as dense tensors.

Counterpart of reference model/locs.rs, redesigned device-first (SURVEY.md §7):
instead of ingesting an external aligner's BAM and "transferring" alignments
between similar haplotypes (locs.rs:404-557, transfer.rs), every recruited
read is aligned directly against every candidate haplotype window on device:

  1. minimizer anchors vote on (haplotype, orientation, diagonal) candidates
     — the moral equivalent of strobealign seeding, batched over reads;
  2. one batched banded-DP call (ops/align.py) scores all candidates and
     yields op counts = error-profile ln-probability + edit distance;
  3. edit-distance thresholds mark reads poorly-mapped / downweight them
     (locs.rs:493-557); per-mate probabilities are normalized by the best
     (locs.rs:352-354); locus-unique k-mers set the read weight
     (locs.rs:905-993);
  4. mates are paired per haplotype with insert-size probabilities and
     unmapped fallbacks, keeping ≤10 within prob_diff (locs.rs:736-858).

The result is a ragged-but-padded candidate table per read pair, the input
to genotype assembly (model/assgn.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import _kernels
from ..bg import BgDistr
from ..bg.err_prof import EditDistCache
from ..ops import align as A
from ..seq.contigs import ContigSet
from ..seq.counts import KmerCounts
from ..seq.kmers import canonical_kmers, minimizers32
from ..utils import spans
from . import Params
from .windows import NeighbProfile

MAX_UNUSED_ALNS = 2   # locs.rs:730
MAX_USED_ALNS = 10    # locs.rs:733


# ---------------------------------------------------------------------------
# Unique k-mer read weights (locs.rs:905-993)
# ---------------------------------------------------------------------------

class UniqueKmers:
    def __init__(self, contig_set: ContigSet, kmer_counts: KmerCounts,
                 hard_thresh: int, soft_thresh: int):
        self.k = kmer_counts.k
        uniq = []
        for seq, counts in zip(contig_set.seqs, kmer_counts.counts):
            km, _, valid = canonical_kmers(seq, self.k)
            uniq.append(km[valid & (counts == 0)])
        self.unique = np.unique(np.concatenate(uniq)) if uniq else np.empty(0, np.uint64)
        self.weight_mult = 1.0 / (soft_thresh + 1 - hard_thresh)
        self.weight_interc = (1.0 - hard_thresh) * self.weight_mult

    def count_read(self, codes: np.ndarray) -> int:
        """Non-overlapping unique k-mers in the read (locs.rs:958-992)."""
        from .. import native
        if native.available() and self.unique.size:
            return native.count_unique_nonoverlap(codes, self.k, self.unique)
        km, _, valid = canonical_kmers(codes, self.k)
        if km.size == 0 or self.unique.size == 0:
            return 0
        idx = np.searchsorted(self.unique, km)
        idx = np.minimum(idx, self.unique.size - 1)
        ismem = (self.unique[idx] == km) & valid
        count = 0
        t = 0
        n = km.size
        while t < n:
            if ismem[t]:
                count += 1
                t += self.k
            else:
                t += 1
        return count

    def count_batch(self, mates) -> np.ndarray:
        """`count_read` over a whole read list — one native call
        (amortizes the ctypes boundary)."""
        from .. import native
        if native.available() and self.unique.size and mates:
            return native.count_unique_nonoverlap_batch(mates, self.k,
                                                        self.unique)
        return np.fromiter((self.count_read(m) for m in mates), np.int64,
                           len(mates))

    def pair_weight(self, count: int) -> float:
        return float(np.clip(self.weight_interc + count * self.weight_mult, 0.0, 1.0))


# ---------------------------------------------------------------------------
# Candidate generation: minimizer anchors -> (hap, orient, diagonal)
# ---------------------------------------------------------------------------

class HapMinimizerIndex:
    """Minimizer hash → sorted (hap, pos, fwd) anchor table over the panel."""

    def __init__(self, contig_set: ContigSet, k: int, w: int):
        self.k = k
        keys, haps, poss, fwds = [], [], [], []
        for hap_ix, seq in enumerate(contig_set.seqs):
            pos, vals, fwd = minimizers32(seq, k, w)
            keys.append(vals)
            haps.append(np.full(pos.size, hap_ix, np.int32))
            poss.append(pos.astype(np.int32))
            fwds.append(fwd)
        kk = np.concatenate(keys) if keys else np.empty(0, np.uint32)
        order = np.argsort(kk, kind="stable")
        self.keys = kk[order]
        self.hap = np.concatenate(haps)[order] if keys else np.empty(0, np.int32)
        self.pos = np.concatenate(poss)[order] if keys else np.empty(0, np.int32)
        self.fwd = np.concatenate(fwds)[order] if keys else np.empty(0, bool)
        self.n_haps = len(contig_set.seqs)

    def candidates_batch_flat(self, mates, w: int, band: int, min_votes: int,
                              max_per_hap: int):
        """(haplotype, orientation, diagonal) candidates of a list of reads
        (orient 0 = forward read, 1 = reverse complement; diag = approximate
        start of the oriented read on the haplotype): one numpy pass of
        lookup + bucket voting + per-(read,hap,orient) top-N for the whole
        batch.  Returns flat int64 arrays (mate_ix, hap, orient, diag),
        grouped by mate."""
        empty = (np.empty(0, np.int64),) * 4
        if self.keys.size == 0:
            return empty
        from .. import native
        if native.available():
            read_ix, pos, vals, fwd = native.minimizers32_batch(
                mates, self.k, w)
            if read_ix.size == 0:
                return empty
            # Full native path: lookup + voting + top-N in C++ (threaded),
            # bit-identical to the numpy grouping below (tests guard).
            rlens_per = np.fromiter((m.size for m in mates), np.int64,
                                    len(mates))
            return native.anchor_votes(
                read_ix, pos, vals, fwd, rlens_per, self.keys, self.hap,
                self.pos, self.fwd, self.k, max(band // 2, 1), min_votes,
                max_per_hap)
        m_read, m_pos, m_hash, m_fwd = [], [], [], []
        for ix, codes in enumerate(mates):
            p_, v_, f_ = minimizers32(codes, self.k, w)
            m_read.append(np.full(p_.size, ix, np.int64))
            m_pos.append(p_)
            m_hash.append(v_)
            m_fwd.append(f_)
        if not m_read:
            return empty
        read_ix = np.concatenate(m_read)
        pos = np.concatenate(m_pos)
        vals = np.concatenate(m_hash)
        fwd = np.concatenate(m_fwd)
        if read_ix.size == 0:
            return empty
        rlens_per = np.array([m.size for m in mates], np.int64)
        rlen = rlens_per[read_ix]

        lo = np.searchsorted(self.keys, vals, side="left")
        hi = np.searchsorted(self.keys, vals, side="right")
        counts = hi - lo
        nz = counts > 0
        if not np.any(nz):
            return empty
        # Expand each minimizer's entry span.
        reps = counts[nz]
        src = np.repeat(np.nonzero(nz)[0], reps)
        offset_in = np.arange(reps.sum()) - np.repeat(
            np.cumsum(reps) - reps, reps)
        e_ix = lo[nz].repeat(reps) + offset_in
        hp = self.hap[e_ix].astype(np.int64)
        same = self.fwd[e_ix] == fwd[src]
        diag_fw = self.pos[e_ix].astype(np.int64) - pos[src]
        diag_rv = self.pos[e_ix].astype(np.int64) - (rlen[src] - self.k - pos[src])
        orient = (~same).astype(np.int64)
        diag = np.where(same, diag_fw, diag_rv)
        bstep = max(band // 2, 1)
        bucket = diag // bstep

        # Group by (read, hap, orient, bucket): lexsort + run-length.
        key_r = read_ix[src]
        order = np.lexsort((bucket, orient, hp, key_r))
        kr, kh, ko, kb, kd = (key_r[order], hp[order], orient[order],
                              bucket[order], diag[order])
        newgrp = np.ones(kr.size, bool)
        newgrp[1:] = ((kr[1:] != kr[:-1]) | (kh[1:] != kh[:-1])
                      | (ko[1:] != ko[:-1]) | (kb[1:] != kb[:-1]))
        starts = np.nonzero(newgrp)[0]
        ends = np.concatenate([starts[1:], [kr.size]])
        votes = ends - starts
        dsum = np.add.reduceat(kd, starts)
        keep = votes >= min_votes
        g_read = kr[starts][keep]
        g_hap = kh[starts][keep]
        g_orient = ko[starts][keep]
        g_votes = votes[keep]
        g_diag = np.round(dsum[keep] / g_votes).astype(np.int64)

        if g_read.size == 0:
            return empty
        # Top-N buckets per (read, hap, orient): sort by votes desc within
        # groups, rank by run-length position, keep rank < max_per_hap.
        order2 = np.lexsort((-g_votes, g_orient, g_hap, g_read))
        sr, sh, so, sd = (g_read[order2], g_hap[order2], g_orient[order2],
                          g_diag[order2])
        new2 = np.ones(sr.size, bool)
        new2[1:] = ((sr[1:] != sr[:-1]) | (sh[1:] != sh[:-1])
                    | (so[1:] != so[:-1]))
        grp_start = np.nonzero(new2)[0]
        rank = np.arange(sr.size) - np.repeat(
            grp_start, np.diff(np.concatenate([grp_start, [sr.size]])))
        sel = rank < max_per_hap
        return sr[sel], sh[sel], so[sel], sd[sel]



# ---------------------------------------------------------------------------
# Alignment records and pairing
# ---------------------------------------------------------------------------

@dataclass
class MateAln:
    hap: int
    start: int
    end: int
    fwd: bool          # True if the read aligned forward
    ln_prob: float
    edit: int
    n_mism: int = 0
    n_ins: int = 0
    n_del: int = 0
    n_clip: int = 0
    ws: int = 0        # window start used by the banded DP (for traceback)

    @property
    def middle(self) -> int:
        return (self.start + self.end) // 2


@dataclass
class PairCand:
    """One candidate location of a read pair (PairAlignment, locs.rs:658-725)."""
    hap: int
    ln_prob: float
    middle1: int       # -1 = mate unmapped
    middle2: int
    aln1: object = None    # MateAln of mate 1 (None = unmapped)
    aln2: object = None


@dataclass
class ReadAlns:
    """All candidate locations for one read pair (GrouppedAlignments)."""
    name: str
    weight: float
    unmapped_prob: float
    cands: list        # list[PairCand], sorted by hap then desc prob
    read_ix: int = -1  # index into the original read_pairs list

    def best_at_hap(self, hap: int, default: float) -> float:
        best = default
        for c in self.cands:
            if c.hap == hap:
                best = max(best, c.ln_prob)
        return best


@dataclass
class MateAlnTable:
    """Flat candidate mate-alignment arrays — one row per (mate, candidate
    window) alignment, straight off the batched device kernel.  The array
    twin of `list[list[MateAln]]` (no per-read Python in the hot path)."""
    mate: np.ndarray     # int64 [A] global mate index
    hap: np.ndarray      # int64
    start: np.ndarray    # int64 hap coordinate of the alignment start
    end: np.ndarray      # int64
    fwd: np.ndarray      # bool — True if the read aligned forward
    prob: np.ndarray     # float64 ln-probability
    edit: np.ndarray     # int64 edit distance
    n_mism: np.ndarray
    n_ins: np.ndarray
    n_del: np.ndarray
    n_clip: np.ndarray
    ws: np.ndarray       # int64 DP window start (for traceback replay)

    _FIELDS = ("mate", "hap", "start", "end", "fwd", "prob", "edit",
               "n_mism", "n_ins", "n_del", "n_clip", "ws")

    @classmethod
    def empty(cls) -> "MateAlnTable":
        z = np.empty(0, np.int64)
        return cls(z, z, z, z, np.empty(0, bool), np.empty(0, np.float64),
                   z, z, z, z, z, z)

    @classmethod
    def concat(cls, tables) -> "MateAlnTable":
        tables = list(tables)
        if not tables:
            return cls.empty()
        return cls(*(np.concatenate([getattr(t, f) for t in tables])
                     for f in cls._FIELDS))

    def select(self, idx) -> "MateAlnTable":
        return MateAlnTable(*(getattr(self, f)[idx] for f in self._FIELDS))

    def __len__(self) -> int:
        return self.mate.size

    def row_obj(self, i: int) -> MateAln:
        return MateAln(hap=int(self.hap[i]), start=int(self.start[i]),
                       end=int(self.end[i]), fwd=bool(self.fwd[i]),
                       ln_prob=float(self.prob[i]), edit=int(self.edit[i]),
                       n_mism=int(self.n_mism[i]), n_ins=int(self.n_ins[i]),
                       n_del=int(self.n_del[i]), n_clip=int(self.n_clip[i]),
                       ws=int(self.ws[i]))

    def to_lists(self, n_mates: int) -> list:
        """Per-mate `list[MateAln]` view (the bg-estimation path)."""
        out = [[] for _ in range(n_mates)]
        for i in range(len(self)):
            out[int(self.mate[i])].append(self.row_obj(i))
        return out

    @property
    def middle(self) -> np.ndarray:
        return (self.start + self.end) // 2


def _mate_matrix(mates, L):
    """[M, L] forward code matrix (pad code 4) and [M] int32 lengths,
    built with one flat-mask assignment — no per-read Python."""
    M = len(mates)
    lens = np.fromiter((m.size for m in mates), np.int32, M)
    fwd = np.full((M, L), 4, np.int8)
    mask = np.arange(L)[None, :] < lens[:, None]
    fwd[mask] = np.concatenate(mates) if M else np.empty(0, np.int8)
    return fwd, lens


#: Byte alignment of each section of a staged job table.
_STAGE_ALIGN = 16


@dataclass
class AlignJobs:
    """K1's inputs as a job table, not job arrays: per locus, its mates as
    one forward [M, L] int8 matrix (pad code 4) with their int32 lengths,
    its haplotypes, and four int32 a job, [4, J]: mate, haplotype, strand
    (1 = the read's reverse complement) and window start (`diag - band //
    2`), indices local to the locus.  `join` makes one table of a group's
    loci without copying a byte; `stage` uploads it, and the device forms
    each batch's reads [n, L] and windows [n, L + band] from it
    (`StagedJobs.gather`).  No [J, L] or [J, L + band] array is built on
    the host."""
    L: int
    mates: list         # per locus [M, L] int8
    mate_lens: list     # per locus [M] int32
    haps: list          # per locus: its haplotypes' int8 code arrays
    cols: list          # per locus [4, J] int32: mate, hap, strand, ws

    def __len__(self) -> int:
        return sum(c.shape[1] for c in self.cols)

    @classmethod
    def join(cls, tables) -> "AlignJobs":
        """One table over a group of loci padded to the same L."""
        tables = list(tables)
        return cls(tables[0].L, *(sum((getattr(t, f) for t in tables), [])
                                  for f in ("mates", "mate_lens", "haps",
                                            "cols")))

    def job_lens(self) -> np.ndarray:
        """[J] int32 read length of every job."""
        return np.concatenate([ml[c[0]] for ml, c in
                               zip(self.mate_lens, self.cols)])

    def _layout(self, band: int):
        """Sizes of the joined table and the byte offset of each section
        of its staging buffer: score vector, mate lengths, job columns,
        haplotype offsets and lengths, mates, padded haplotypes."""
        W = self.L + band
        M = sum(m.shape[0] for m in self.mates)
        hap_len = np.fromiter((s.size for hs in self.haps for s in hs),
                              np.int64)
        # Every haplotype has W pad codes before and after it.
        hap_off = W + np.cumsum(hap_len + W) - (hap_len + W)
        F = W * (hap_len.size + 1) + int(hap_len.sum())
        offs = [0]
        for n in (4 * 5, 4 * M, 4 * 4 * len(self), 4 * hap_len.size,
                  4 * hap_len.size, M * self.L, F):
            offs.append(offs[-1] + -(-n // _STAGE_ALIGN) * _STAGE_ALIGN)
        return W, M, hap_len, hap_off, F, offs

    def staged_nbytes(self, band: int) -> int:
        """Bytes that `stage` writes on the host and uploads."""
        return self._layout(band)[-1][-1]

    def stage(self, score_vec, band: int, dev) -> "StagedJobs":
        """Writes the table into one staging buffer (pinned on a card) and
        uploads it to `dev` with `non_blocking=True`: the score vector, the
        mates [M, L] and their lengths, the haplotypes as one flat int8
        buffer with W = L + band pad codes before and after each, and the
        job columns, each locus's mate and haplotype indices offset into
        the group's.  Counts its bytes in `k1_staged_bytes`."""
        W, M, hap_len, hap_off, F, offs = self._layout(band)
        J, L = len(self), self.L
        buf = torch.empty(offs[-1], dtype=torch.uint8,
                          pin_memory=dev.type == "cuda")
        host = buf.numpy()

        def section(i, dtype):
            return host[offs[i]:offs[i + 1]].view(dtype)

        section(0, np.float32)[:5] = np.asarray(score_vec, np.float32)
        lens, cols = section(1, np.int32), section(2, np.int32)
        cols = cols[:4 * J].reshape(4, J)
        section(3, np.int32)[:hap_len.size] = hap_off
        section(4, np.int32)[:hap_len.size] = hap_len
        mates = section(5, np.int8)[:M * L].reshape(M, L)
        flat = section(6, np.int8)
        flat.fill(4)
        m0 = j0 = h0 = 0
        for mat, ml, hs, c in zip(self.mates, self.mate_lens, self.haps,
                                  self.cols):
            n = c.shape[1]
            np.add(c[0], m0, out=cols[0, j0:j0 + n])
            np.add(c[1], h0, out=cols[1, j0:j0 + n])
            cols[2:, j0:j0 + n] = c[2:]
            mates[m0:m0 + mat.shape[0]] = mat
            lens[m0:m0 + mat.shape[0]] = ml
            for h, seq in enumerate(hs, h0):
                flat[hap_off[h]:hap_off[h] + seq.size] = seq
            m0, j0, h0 = m0 + mat.shape[0], j0 + n, h0 + len(hs)
        spans.count("k1_staged_bytes", buf.numel())

        d = buf.to(dev, non_blocking=True)

        def dev_section(i, dtype, n):
            return d[offs[i]:offs[i] + n * dtype.itemsize].view(dtype)

        return StagedJobs(
            L, band, dev_section(0, torch.float32, 5),
            dev_section(1, torch.int32, M),
            dev_section(2, torch.int32, 4 * J).view(4, J),
            dev_section(3, torch.int32, hap_len.size),
            dev_section(4, torch.int32, hap_len.size),
            dev_section(5, torch.int8, M * L).view(M, L),
            dev_section(6, torch.int8, F))


class StagedJobs:
    """A job table on its device, and each batch's K1 inputs gathered
    there.  Once a group: the reads of both strands as one [2 M, L] stack
    (forward rows, then their reverse complements, pad 4 after each read's
    length), one row of it and one window start a job.  A window is a row
    of the padded haplotypes' `unfold(0, W, 1)` view, its start clamped to
    [-W, haplotype length], where the window is wholly padding — the bytes
    of `ops/align.py:extract_windows`."""

    def __init__(self, L, band, score_vec, mate_lens, cols, hap_off, hap_len,
                 fwd, flat):
        W = L + band
        self.band, self.score_vec = band, score_vec
        M = fwd.shape[0]
        comp = torch.where(fwd < 4, 3 - fwd, 4)
        # Reverse complement of row m: its flipped row, read from
        # L - len[m] on, with pad codes behind it.
        ext = torch.cat([comp.flip(1), torch.full_like(comp, 4)], 1)
        rc = ext.unfold(1, L, 1)[torch.arange(M, device=fwd.device),
                                 L - mate_lens.long()]
        self.reads = torch.cat([fwd, rc])
        mate, hap = cols[0].long(), cols[1].long()
        self.read_row = cols[2].long() * M + mate
        ws = torch.minimum(cols[3].clamp(min=-W), hap_len[hap])
        self.win_row = hap_off[hap].long() + ws.long()
        self.wins = flat.unfold(0, W, 1)
        self.lens = mate_lens[mate]

    def gather(self, lo: int, hi: int, n: int | None = None):
        """(reads [n, L] int8, lens [n] int32, wins [n, L + band] int8) of
        jobs lo..hi, padded to `n` rows with N reads of length 0 in N
        windows (a shard's padding)."""
        reads = self.reads.index_select(0, self.read_row[lo:hi])
        wins = self.wins.index_select(0, self.win_row[lo:hi])
        lens = self.lens[lo:hi]
        pad = (hi - lo if n is None else n) - (hi - lo)
        if pad:
            reads = torch.cat([reads, reads.new_full((pad, reads.shape[1]),
                                                     4)])
            wins = torch.cat([wins, wins.new_full((pad, wins.shape[1]), 4)])
            lens = torch.cat([lens, lens.new_zeros(pad)])
        return reads, lens, wins


def _prepare_align_jobs(mates, jobs, contig_set, band, L: int | None = None):
    """The job table of one locus (`AlignJobs`) and the job meta of
    `_finish_align`: (mate, hap, orient, window start), int64.  `L` may be
    forced larger (multi-locus batching pads every locus to the panel
    bucket — safe: the kernel never reads past lens[i] + band)."""
    jm, jh, jo, jd = (np.asarray(a, np.int64) for a in jobs)
    max_read = max(m.size for m in mates)
    L = L or (-(-max_read // 64) * 64)
    fwd, lens = _mate_matrix(mates, L)
    all_ws = jd - band // 2
    table = AlignJobs(L, [fwd], [lens], [list(contig_set.seqs)],
                      [np.stack([jm, jh, jo, all_ws]).astype(np.int32)])
    return table, (jm, jh, jo, all_ws)


def run_align_batches(jobs: AlignJobs, score_vec, band,
                      batch: int | None = None, device=None,
                      mesh=None) -> dict:
    """Streams a job table through the alignment kernel in batches; one
    blocking wait per batch at the end (launches and copies overlap) —
    the reference's alignment worker pool (locs.rs:1120-1146).  With
    `mesh`, each batch is split over the grid's shards
    (parallel/mesh.py:sharded_align).

    device: None = CUDA (raises without one); "cpu" = the plain PyTorch
    version of the kernel."""
    return collect_align_batches(
        dispatch_align_batches(jobs, score_vec, band, batch=batch,
                               device=device, mesh=mesh))


def align_async(staged: StagedJobs, lo: int, hi: int, n: int | None = None):
    """Jobs lo..hi of a staged table (padded to `n` rows) on its device:
    reads and windows gathered there, aligned by one kernel launch, its
    eight outputs leaving as ONE [8, n] int32 tensor copied asynchronously
    into pinned host memory.  Returns (result, event); the event, recorded
    on the device's current stream, marks the copy's end (None on the
    CPU)."""
    reads, lens, wins = staged.gather(lo, hi, n)
    res = _pack_align_results(A.align_banded(reads, lens, wins,
                                             staged.score_vec, staged.band))
    if res.device.type != "cuda":
        return res, None
    host = torch.empty(res.shape, dtype=res.dtype, pin_memory=True)
    host.copy_(res, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(res.device))
    return host, event


def dispatch_align_batches(jobs: AlignJobs, score_vec, band,
                           batch: int | None = None, device=None,
                           mesh=None) -> list:
    """Dispatch half of `run_align_batches`: stages the job table on the
    device once (`AlignJobs.stage`), queues every batch there
    (`align_async`) and returns the pending list without waiting for the
    kernels — callers may overlap host work (candidate voting of the next
    locus group, post-alignment of the previous) with the device leg.
    With `mesh`, every batch is split over the grid's shards, each shard's
    copy marked by an event on its own device; `device` is then unused."""
    J, L = len(jobs), jobs.L
    spans.count("k1_jobs", J)
    if not J:
        return []
    if batch is None:
        # ~6 M read bases per launch: bounds the device buffers, any J runs.
        batch = max(512, min(32768, (6 << 20) // max(int(L), 1)))
    bounds = [(s, min(s + batch, J)) for s in range(0, J, batch)]
    if mesh is not None:
        from ..parallel.mesh import dispatch_sharded_align
        staged: dict = {}
        return [p for rows in bounds for p in dispatch_sharded_align(
            mesh, jobs, score_vec, band, rows=rows, staged=staged)]
    staged = jobs.stage(score_vec, band, _kernels.resolve_device(device))
    return [align_async(staged, lo, hi) + (hi - lo,) for lo, hi in bounds]


def collect_align_batches(pending: list) -> dict:
    """Fetch half of `run_align_batches`: waits for each batch's copy and
    keeps its first `keep` rows (a shard's padding rows go)."""
    if not pending:
        return {}
    out: dict = {k: [] for k in _ALIGN_KEYS}
    for res, event, keep in pending:
        if event is not None:
            event.synchronize()
        for k, v in _unpack_align_results(res.numpy()[:, :keep]).items():
            out[k].append(v)
    return {k: np.concatenate(v) for k, v in out.items()}


_ALIGN_KEYS = A.ALIGN_RESULT_KEYS      # packed [8, N] result row order


def _pack_align_results(res: dict):
    """[8, N] int32 tensor of the aligner outputs (score bit-cast), so that
    a batch comes back in one copy."""
    rows = []
    for k in _ALIGN_KEYS:
        v = res[k]
        rows.append(v.view(torch.int32) if v.dtype == torch.float32
                    else v.to(torch.int32))
    return torch.stack(rows)


def _unpack_align_results(arr: np.ndarray) -> dict:
    out = {}
    for i, k in enumerate(_ALIGN_KEYS):
        v = arr[i]
        if k == "score":
            v = v.view(np.float32)
        elif k == "valid":
            v = v.astype(bool)
        out[k] = v
    return out


def _finish_align(res: dict, meta, lens) -> MateAlnTable:
    """Turns flat kernel outputs + job meta into a MateAlnTable."""
    jm, jh, jo, all_ws = meta
    edit, _ = A.edit_and_matches(res, lens)
    return MateAlnTable(
        mate=jm, hap=jh,
        start=all_ws + res["start_p"].astype(np.int64),
        end=all_ws + res["end_p"].astype(np.int64),
        fwd=jo == 0,
        prob=res["score"].astype(np.float64),
        edit=edit.astype(np.int64),
        n_mism=res["n_mism"].astype(np.int64),
        n_ins=res["n_ins"].astype(np.int64),
        n_del=res["n_del"].astype(np.int64),
        n_clip=res["n_clip"].astype(np.int64),
        ws=all_ws.copy())


def _align_candidates(mates, jobs, contig_set, score_vec, band,
                      batch=2048, device=None) -> MateAlnTable:
    """Aligns every (mate, candidate) job on device; returns a flat
    MateAlnTable in job order.

    mates: list of code arrays; jobs: flat arrays (mate_ix, hap, orient,
    diag) from `candidates_batch_flat`.  Batch assembly and result
    collection are fully vectorized."""
    if np.asarray(jobs[0]).size == 0:
        return MateAlnTable.empty()
    table, meta = _prepare_align_jobs(mates, jobs, contig_set, band)
    res = run_align_batches(table, score_vec, band, batch=batch,
                            device=device)
    return _finish_align(res, meta, table.job_lens())


# ---------------------------------------------------------------------------
# Array-native result container
# ---------------------------------------------------------------------------

class AllAlignments:
    """Array-native candidate store for one locus (read × hap × location).

    The hot path (tensor build, stage-0 filter) reads the flat arrays;
    `reads`/`unused_reads` materialize the ReadAlns/PairCand/MateAln object
    view lazily for SAM and debug output (model/sam.py, --debug CSVs).

    Candidate arrays are grouped by used-read index, then hap asc, then
    weighted ln-prob desc — exactly the slot order LocusTensors expects.
    """

    def __init__(self, *, n_haps, table, read_ix, names, weights, unmapped,
                 c_read, c_hap, c_prob, c_mid1, c_mid2, c_a1, c_a2, used_mask):
        self.n_haps = n_haps
        self.table = table              # MateAlnTable (deduped + filtered)
        self.read_ix = read_ix          # [S] original read index (survivors)
        self.names = names              # list[str] per survivor
        self.weights = weights          # [S] float
        self.unmapped = unmapped        # [S] float (weighted unmapped prob)
        self.c_read = c_read            # [C] survivor index
        self.c_hap = c_hap
        self.c_prob = c_prob            # weighted pair ln-prob
        self.c_mid1 = c_mid1
        self.c_mid2 = c_mid2
        self.c_a1 = c_a1                # row into `table`, -1 = unmapped mate
        self.c_a2 = c_a2
        self.used_mask = used_mask      # [S] bool: weight >= min_weight
        self._objs = None

    # -- hot-path views ----------------------------------------------------
    @property
    def n_used(self) -> int:
        return int(self.used_mask.sum())

    @property
    def names_used(self) -> list:
        return [n for n, u in zip(self.names, self.used_mask) if u]

    @property
    def weights_used(self) -> np.ndarray:
        return self.weights[self.used_mask]

    def used_candidates(self):
        """(c_read_remapped, c_hap, c_prob, c_mid1, c_mid2) over used reads,
        with read indices renumbered 0..n_used-1."""
        pos = np.cumsum(self.used_mask) - 1       # survivor -> used position
        keep = self.used_mask[self.c_read]
        return (pos[self.c_read[keep]], self.c_hap[keep], self.c_prob[keep],
                self.c_mid1[keep], self.c_mid2[keep])

    def best_aln_matrix(self) -> np.ndarray:
        """[n_haps, n_used] best weighted ln-prob per hap, defaulting to the
        read's unmapped prob (locs.rs:1177-1186)."""
        cr, ch, cp, _, _ = self.used_candidates()
        out = np.tile(self.unmapped[self.used_mask], (self.n_haps, 1))
        if cr.size:
            np.maximum.at(out, (ch, cr), cp)
        return out

    # -- lazy object view --------------------------------------------------
    def _build_objects(self):
        if self._objs is not None:
            return self._objs
        row_cache: dict = {}

        def row_obj(i):
            if i < 0:
                return None
            o = row_cache.get(i)
            if o is None:
                o = self.table.row_obj(i)
                row_cache[i] = o
            return o

        reads, unused = [], []
        S = len(self.names)
        bounds = np.searchsorted(self.c_read, np.arange(S + 1))
        for s in range(S):
            cands = [PairCand(int(self.c_hap[i]), float(self.c_prob[i]),
                              int(self.c_mid1[i]), int(self.c_mid2[i]),
                              row_obj(int(self.c_a1[i])),
                              row_obj(int(self.c_a2[i])))
                     for i in range(bounds[s], bounds[s + 1])]
            ra = ReadAlns(self.names[s], float(self.weights[s]),
                          float(self.unmapped[s]), cands,
                          read_ix=int(self.read_ix[s]))
            (reads if self.used_mask[s] else unused).append(ra)
        self._objs = (reads, unused)
        return self._objs

    @property
    def reads(self) -> list:
        return self._build_objects()[0]

    @property
    def unused_reads(self) -> list:
        return self._build_objects()[1]


def build_all_alignments(read_pairs, names, contig_set: ContigSet,
                         kmer_counts: KmerCounts, bg: BgDistr,
                         edit_cache: EditDistCache, params: Params,
                         minimizer_k: int = 15, minimizer_w: int = 10,
                         explicit_weights=None, device=None, mesh=None,
                         profile: NeighbProfile | None = None):
    """The full locs pipeline, fully vectorized: candidates → device
    alignment → dedup → edit/bounds filters → weights → pairing →
    per-(read,hap) top-K.  `read_pairs`: list of (codes1, codes2|None).

    explicit_weights: optional model.windows.ExplicitWeights — alignment
    ln-probs are then recomputed per-op with region weights
    (windows.rs:508-575 / err_prof.rs:225-266; the CIGARs come from the
    host traceback kernel replayed at the stored DP windows).
    profile: the locus's NeighbProfile of this call, shared with the
    solver's inputs (None: built here on demand).

    Semantics are bit-identical to the JAX package's per-read oracle
    (tests/test_torch_locs.py holds this path against that package)."""
    gen = _build_all_alignments_gen(read_pairs, names, contig_set,
                                    kmer_counts, bg, edit_cache, params,
                                    minimizer_k, minimizer_w,
                                    explicit_weights=explicit_weights,
                                    profile=profile)
    req = next(gen)
    res = None
    if req is not None:
        res = run_align_batches(*req, device=device, mesh=mesh)
    return gen.send(res)


def build_all_alignments_panel(panel, bg: BgDistr, edit_cache: EditDistCache,
                               params: Params, minimizer_k: int = 15,
                               minimizer_w: int = 10,
                               group_size: int | None = None, device=None,
                               mesh=None, profiles: list | None = None):
    """Multi-locus device batching: candidate alignment jobs run as a
    global device stream (shared [*, L] bucket), amortizing dispatch
    latency across the panel.  Results are identical to per-locus
    `build_all_alignments` (tests/test_panel.py).

    The panel is processed in GROUPS of `group_size` loci through a
    3-stage pipeline: a worker thread runs candidate voting for group i+1
    while the main thread dispatches group i's device batches (async)
    and digests group i-1's results — the host cand/post phases hide
    behind the device leg instead of serializing with it.  Per-locus
    results are order-independent, so grouping cannot change them.

    panel: list of (read_pairs, names, contig_set, kmer_counts) tuples,
    optionally with a 5th element (ExplicitWeights | None — per-locus
    region-weighted alignment probs, windows.rs:508-575).
    mesh: optional parallel/mesh.py grid; every device batch is then split
    over its shards (`device` unused).
    profiles: optional list of the call's NeighbProfile of each locus, in
    panel order, shared with the solver's inputs (None: each built here on
    demand).
    Returns list of (AllAlignments, stats) in panel order.
    """
    from concurrent.futures import ThreadPoolExecutor

    if group_size is None:
        # >= 3 groups whenever the panel allows it, so the pipeline's
        # overlap actually engages on small panels too (a 5-locus HLA
        # panel was one group = fully serial host legs), capped at 16 so
        # large panels still amortize dispatch batches.
        group_size = max(1, min(16, -(-len(panel) // 3)))

    max_read = max((m.size for item in panel for pair in item[0]
                    for m in pair if m is not None), default=64)
    L = -(-max_read // 64) * 64

    def cand_group(idxs, layer):
        """Host stage 1: build generators + candidate voting (to the first
        yield) for one locus group, on the worker thread (`layer`: the
        parent of its spans)."""
        gens, reqs = [], []
        for i in idxs:
            read_pairs, names, contig_set, kmer_counts = panel[i][:4]
            ew = panel[i][4] if len(panel[i]) > 4 else None
            g = _build_all_alignments_gen(
                read_pairs, names, contig_set, kmer_counts, bg, edit_cache,
                params, minimizer_k, minimizer_w, panel_L=L,
                explicit_weights=ew, span_parent=layer,
                profile=profiles[i] if profiles is not None else None)
            reqs.append(next(g))
            gens.append(g)
        return idxs, gens, reqs

    def dispatch_group(reqs):
        """Device stage: one async dispatch of the group's joined job
        tables (one upload); returns (pending, live, sizes)."""
        live = [j for j, r in enumerate(reqs) if r is not None]
        if not live:
            return None, live, []
        score_vec, band = reqs[live[0]][1:]
        jobs = AlignJobs.join(reqs[j][0] for j in live)
        pending = dispatch_align_batches(jobs, score_vec, band,
                                         device=device, mesh=mesh)
        return pending, live, [len(reqs[j][0]) for j in live]

    out = [None] * len(panel)

    def finalize_group(idxs, gens, pending, live, sizes):
        """Host stage 3: fetch the group's results and run per-locus
        post-alignment."""
        results = [None] * len(gens)
        if pending is not None:
            with spans.span("align.wait"):
                res = collect_align_batches(pending)
            off = 0
            for j, n in zip(live, sizes):
                results[j] = {k: v[off:off + n] for k, v in res.items()}
                off += n
        with spans.span("align.post"):
            for j, g in enumerate(gens):
                out[idxs[j]] = g.send(results[j])

    groups = [list(range(s, min(s + group_size, len(panel))))
              for s in range(0, len(panel), group_size)]
    layer = spans.current()         # the worker's spans name it
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(cand_group, groups[0], layer)
        prev = None
        for gi in range(len(groups)):
            with spans.span("align.wait"):
                idxs, gens, reqs = fut.result()
            if gi + 1 < len(groups):
                fut = pool.submit(cand_group, groups[gi + 1], layer)
            with spans.span("align.dispatch"):
                pending, live, sizes = dispatch_group(reqs)
            if prev is not None:
                finalize_group(*prev)
            prev = (idxs, gens, pending, live, sizes)
        finalize_group(*prev)
    return out


def _reweight_aln_probs(tbl, mates, contig_set, err_prof, explicit_weights,
                        score_vec, band: int) -> None:
    """Recomputes tbl.prob in place with region-weight-aware per-op
    probabilities (windows.rs:508-575 weighted_aln_prob; the reference
    applies it to every stored alignment when `--reg-weights` is given).
    CIGARs are replayed by the host traceback kernel at the stored DP
    windows — the exact DP the scoring kernel ran."""
    from ..ops import align as A
    from ..ops import traceback as T
    from ..seq import dna

    names = contig_set.contigs.names
    w_arrs = {}
    for i in range(len(tbl)):
        h = int(tbl.hap[i])
        hap_seq = contig_set.seqs[h]
        if h not in w_arrs:
            w_arrs[h] = explicit_weights.per_bp(names[h], hap_seq.size)
        codes = mates[int(tbl.mate[i])]
        oriented = codes if tbl.fwd[i] else dna.revcomp(codes)
        ws = int(tbl.ws[i])
        win = A.extract_windows(hap_seq, np.array([ws]),
                                oriented.size + band)[0]
        out = T.align_cigar(oriented, win, band, score_vec)
        if out is None:
            continue
        ops, lens, info, _ = out
        prob, _edit, _ = err_prof.weighted_aln_ln_prob(
            ops, lens, ws + int(info[0]), ws + int(info[1]), w_arrs[h],
            hap_seq.size)
        tbl.prob[i] = prob


def _build_all_alignments_gen(read_pairs, names, contig_set: ContigSet,
                              kmer_counts: KmerCounts, bg: BgDistr,
                              edit_cache: EditDistCache, params: Params,
                              minimizer_k: int = 15, minimizer_w: int = 10,
                              panel_L: int | None = None,
                              explicit_weights=None, span_parent=None,
                              profile: NeighbProfile | None = None):
    """Coroutine body of `build_all_alignments`: yields ONE device-align
    request (job table, score_vec, band) — or None when no
    candidates — then receives the kernel outputs via .send() and yields
    the final (AllAlignments, stats).  Its `align.vote` and `align.jobs`
    spans name `span_parent` as their parent (the `align` span of a worker
    thread's caller), or else the innermost span open on their thread.
    `profile` (model/windows.py:NeighbProfile) gives the short-read
    relaxation its complexity; None builds one here."""
    with spans.span("align.vote", parent=span_parent):
        is_paired = bg.insert_distr.is_paired_end
        tweak = params.tweak if params.tweak is not None else 0
        boundary = params.boundary_size - tweak
        score_vec = bg.err_prof.score_vec()
        hap_index = HapMinimizerIndex(contig_set, minimizer_k, minimizer_w)
        uniq = UniqueKmers(contig_set, kmer_counts,
                           params.kmer_hard_thresh, params.kmer_soft_thresh)
        hap_lens = np.fromiter((s.size for s in contig_set.seqs), np.int64,
                               len(contig_set.seqs))
        n_haps = len(contig_set.seqs)
        R = len(read_pairs)
        stats = dict(total=R, poorly_mapped=0, out_of_bounds=0,
                     few_kmers=0, n_alns=0)

        # Flatten mates, generate candidates, batch-align.
        mates = []
        m_read, m_slot = [], []
        for r, (c1, c2) in enumerate(read_pairs):
            mates.append(c1)
            m_read.append(r)
            m_slot.append(0)
            if c2 is not None:
                mates.append(c2)
                m_read.append(r)
                m_slot.append(1)
        M = len(mates)
        m_read = np.array(m_read, np.int64)
        m_slot = np.array(m_slot, np.int64)
        has2 = np.fromiter((c2 is not None for _, c2 in read_pairs), bool, R)

        jobs = hap_index.candidates_batch_flat(mates, minimizer_w, params.band,
                                               params.min_anchor_votes,
                                               max_per_hap=3)
    if np.asarray(jobs[0]).size == 0:
        _ = yield None                   # resumed by .send(None)
        tbl = MateAlnTable.empty()
    else:
        with spans.span("align.jobs", parent=span_parent):
            table, meta = _prepare_align_jobs(mates, jobs, contig_set,
                                              params.band, L=panel_L)
        res = yield (table, score_vec, params.band)
        tbl = _finish_align(res, meta, table.job_lens())

    empty64 = np.empty(0, np.int64)
    empty_result = AllAlignments(
        n_haps=n_haps, table=MateAlnTable.empty(),
        read_ix=empty64, names=[], weights=np.empty(0),
        unmapped=np.empty(0), c_read=empty64, c_hap=empty64,
        c_prob=np.empty(0), c_mid1=empty64, c_mid2=empty64,
        c_a1=empty64, c_a2=empty64, used_mask=np.empty(0, bool))

    # -- A) dedup per (mate, hap, 128bp start bin): keep the best prob;
    #       group order = first occurrence (as the JAX package's per-read
    #       oracle inserts into its dict).
    if len(tbl) == 0:
        stats["poorly_mapped"] = R
        yield empty_result, stats
        return
    bin_ = tbl.start >> 7
    order = np.lexsort((-tbl.prob, bin_, tbl.hap, tbl.mate))
    km, khp, kb = tbl.mate[order], tbl.hap[order], bin_[order]
    first = np.ones(order.size, bool)
    first[1:] = (km[1:] != km[:-1]) | (khp[1:] != khp[:-1]) | (kb[1:] != kb[:-1])
    gid = np.cumsum(first) - 1
    n_grp = int(gid[-1]) + 1
    grp_min_orig = np.full(n_grp, 1 << 62)
    np.minimum.at(grp_min_orig, gid, order)
    reps = order[first]                      # best row of each group
    reps = reps[np.argsort(grp_min_orig, kind="stable")]
    tbl = tbl.select(reps)

    if explicit_weights is not None:
        _reweight_aln_probs(tbl, mates, contig_set, bg.err_prof,
                            explicit_weights, score_vec, params.band)

    # -- B) per-mate edit-distance thresholds (err_prof.rs:415-455).
    mate_len = np.fromiter((m.size for m in mates), np.int64, M)
    ulen, inv = np.unique(mate_len, return_inverse=True)
    thr = np.array([edit_cache.get(int(L)) for L in ulen], np.int64)
    good_m, pass_m = thr[inv, 0].copy(), thr[inv, 1].copy()
    # Low-complexity neighbourhoods relax the thresholds for short reads
    # (locs.rs:510-528): a mate whose primary (best-prob) alignment sits
    # where linguistic complexity <= poor_compl accepts edits up to
    # poor_compl_edit * len.
    if bg.seq_info.technology.are_short_reads and len(tbl):
        neighb = bg.depth.neighb_size
        if profile is None:
            profile = NeighbProfile(contig_set, kmer_counts, neighb, params)
        compl_arrs = profile.compl
        order2 = np.lexsort((-tbl.prob, tbl.mate))
        pm_sorted = tbl.mate[order2]
        first2 = np.ones(order2.size, bool)
        first2[1:] = pm_sorted[1:] != pm_sorted[:-1]
        prim = order2[first2]                      # best row per mate
        pm = tbl.mate[prim]
        mid = tbl.middle[prim]
        hp = tbl.hap[prim]
        half = neighb // 2
        compl = np.ones(prim.size)
        for h in np.unique(hp):
            rows = np.nonzero(hp == h)[0]
            ca = compl_arrs[h]
            if ca.size == 0:
                continue
            ix = np.clip(mid[rows] - half, 0, ca.size - 1).astype(np.int64)
            compl[rows] = np.nan_to_num(ca[ix], nan=1.0)
        relax_m = np.zeros(M, bool)
        relax_m[pm] = compl <= params.poor_compl
        thr_rel = np.maximum(good_m,
                             (params.poor_compl_edit * mate_len).astype(
                                 np.int64))
        pass_m = pass_m + np.where(relax_m, thr_rel - good_m, 0)
        good_m = np.where(relax_m, thr_rel, good_m)
    tbl = tbl.select(tbl.edit <= pass_m[tbl.mate])

    has_aln = np.zeros(M, bool)
    has_aln[tbl.mate] = True
    best_edit = np.full(M, 1 << 30, np.int64)
    np.minimum.at(best_edit, tbl.mate, tbl.edit)
    mate_ok = has_aln & (best_edit <= good_m)
    well = np.ones(R, bool)
    np.logical_and.at(well, m_read, mate_ok)
    if is_paired:
        well &= has2
    stats["poorly_mapped"] = int(R - well.sum())

    # -- C) in-bounds: any alignment middle inside [boundary, len-boundary)
    #       (locs.rs:998-1004).
    mid = tbl.middle
    inb_row = (mid >= boundary) & (mid < hap_lens[tbl.hap] - boundary)
    read_inb = np.zeros(R, bool)
    np.logical_or.at(read_inb, m_read[tbl.mate], inb_row)
    stats["out_of_bounds"] = int((well & ~read_inb).sum())
    survive = well & read_inb
    if not survive.any():
        yield empty_result, stats
        return

    # -- D) unique-kmer pair weights (locs.rs:905-993).
    mate_uniq = uniq.count_batch(mates)
    pair_uniq = np.zeros(R, np.int64)
    np.add.at(pair_uniq, m_read, mate_uniq)
    weight = np.clip(uniq.weight_interc + pair_uniq * uniq.weight_mult,
                     0.0, 1.0)

    # -- E) per-mate normalization by the best ln-prob (locs.rs:352-354).
    mmax = np.full(M, -np.inf)
    np.maximum.at(mmax, tbl.mate, tbl.prob)
    tbl.prob = tbl.prob - mmax[tbl.mate]

    # -- F) pair / single candidates for surviving reads.
    insert_distr = bg.insert_distr
    unm_ins_penalty = params.unmapped_penalty + insert_distr.insert_penalty
    rows = np.nonzero(survive[m_read[tbl.mate]])[0]
    sr_read = m_read[tbl.mate[rows]]
    sr_slot = m_slot[tbl.mate[rows]]
    sr_hap = tbl.hap[rows]

    if is_paired:
        # Sort rows by (read, hap, slot); groups are (read, hap).
        so = np.lexsort((sr_slot, sr_hap, sr_read))
        g_read, g_hap, g_slot = sr_read[so], sr_hap[so], sr_slot[so]
        g_rows = rows[so]
        gnew = np.ones(so.size, bool)
        gnew[1:] = (g_read[1:] != g_read[:-1]) | (g_hap[1:] != g_hap[:-1])
        ggid = np.cumsum(gnew) - 1
        G = int(ggid[-1]) + 1
        is0 = g_slot == 0
        n1 = np.bincount(ggid[is0], minlength=G)
        n2 = np.bincount(ggid[~is0], minlength=G)
        rows0 = g_rows[is0]                 # mate-1 rows, grouped by gid
        rows1_ = g_rows[~is0]               # mate-2 rows, grouped by gid
        o1 = np.cumsum(n1) - n1
        o2 = np.cumsum(n2) - n2
        P = n1 * n2
        T = int(P.sum())
        if T:
            gpair = np.repeat(np.arange(G), P)
            t = np.arange(T) - np.repeat(np.cumsum(P) - P, P)
            i1 = rows0[o1[gpair] + t // np.maximum(n2[gpair], 1)]
            i2 = rows1_[o2[gpair] + t % np.maximum(n2[gpair], 1)]
            opp = tbl.fwd[i1] != tbl.fwd[i2]
            ins = (np.maximum(tbl.end[i1], tbl.end[i2])
                   - np.minimum(tbl.start[i1], tbl.start[i2]))
            pp = tbl.prob[i1] + tbl.prob[i2] + insert_distr.ln_prob(ins)
            okp = opp & np.isfinite(pp)
            pm = np.where(okp, pp, -np.inf)
        else:
            gpair = t = i1 = i2 = empty64
            okp = np.empty(0, bool)
            pp = pm = np.empty(0)
        # Per-row max over this row's pairings (within its (read,hap) group).
        max_r = np.full(len(tbl), -np.inf)
        if T:
            np.maximum.at(max_r, i1, pm)
            np.maximum.at(max_r, i2, pm)
        mid_all = tbl.middle
        # combos (kept in cross-product order), then mate-1 singles, then
        # mate-2 singles — the JAX package's per-read oracle's order, so ties
        # resolve identically under the stable sort below.
        grp_read = g_read[np.nonzero(gnew)[0]]
        grp_hap = g_hap[np.nonzero(gnew)[0]]
        comb_read = grp_read[gpair[okp]] if T else empty64
        comb_hap = grp_hap[gpair[okp]] if T else empty64
        comb = dict(read=comb_read, hap=comb_hap,
                    prob=pp[okp], mid1=mid_all[i1[okp]], mid2=mid_all[i2[okp]],
                    a1=i1[okp], a2=i2[okp],
                    rank=np.zeros(int(okp.sum()), np.int64))
        alone = tbl.prob[rows] + unm_ins_penalty
        ks = alone >= max_r[rows]
        s0 = ks & (sr_slot == 0)
        s1 = ks & (sr_slot == 1)
        sing0 = dict(read=sr_read[s0], hap=sr_hap[s0], prob=alone[s0],
                     mid1=mid_all[rows[s0]],
                     mid2=np.full(int(s0.sum()), -1, np.int64),
                     a1=rows[s0], a2=np.full(int(s0.sum()), -1, np.int64),
                     rank=np.ones(int(s0.sum()), np.int64))
        sing1 = dict(read=sr_read[s1], hap=sr_hap[s1], prob=alone[s1],
                     mid1=np.full(int(s1.sum()), -1, np.int64),
                     mid2=mid_all[rows[s1]],
                     a1=np.full(int(s1.sum()), -1, np.int64), a2=rows[s1],
                     rank=np.full(int(s1.sum()), 2, np.int64))
        cand = {k: np.concatenate([comb[k], sing0[k], sing1[k]])
                for k in comb}
    else:
        s0 = sr_slot == 0
        mid_all = tbl.middle
        cand = dict(read=sr_read[s0], hap=sr_hap[s0],
                    prob=tbl.prob[rows[s0]], mid1=mid_all[rows[s0]],
                    mid2=np.full(int(s0.sum()), -1, np.int64),
                    a1=rows[s0], a2=np.full(int(s0.sum()), -1, np.int64),
                    rank=np.zeros(int(s0.sum()), np.int64))

    # -- G) per-(read, hap) ordering + top-K threshold (locs.rs:730-733).
    pos = np.arange(cand["read"].size)
    oc = np.lexsort((pos, cand["rank"], -cand["prob"],
                     cand["hap"], cand["read"]))
    for k in cand:
        cand[k] = cand[k][oc]
    cr, chp, cp = cand["read"], cand["hap"], cand["prob"]
    gnew = np.ones(cr.size, bool)
    gnew[1:] = (cr[1:] != cr[:-1]) | (chp[1:] != chp[:-1])
    gstart = np.nonzero(gnew)[0]
    gsize = np.diff(np.concatenate([gstart, [cr.size]]))
    rank_in = np.arange(cr.size) - np.repeat(gstart, gsize)
    best_b = np.repeat(cp[gstart], gsize)
    max_alns = np.where(weight >= params.min_weight,
                        MAX_USED_ALNS, MAX_UNUSED_ALNS)
    keepc = (rank_in < max_alns[cr]) & (cp >= best_b - params.prob_diff)
    for k in cand:
        cand[k] = cand[k][keepc]

    # -- H) weights, unmapped probs, survivor packing.
    cand["prob"] = cand["prob"] * weight[cand["read"]]
    stats["n_alns"] = int(cand["read"].size)
    surv_ix = np.nonzero(survive)[0]
    surv_pos = np.full(R, -1, np.int64)
    surv_pos[surv_ix] = np.arange(surv_ix.size)
    if is_paired:
        unmapped = weight * (2.0 * params.unmapped_penalty
                             + insert_distr.insert_penalty)
    else:
        unmapped = weight * params.unmapped_penalty
    used_mask = weight[surv_ix] >= params.min_weight
    stats["few_kmers"] = int((~used_mask).sum())

    result = AllAlignments(
        n_haps=n_haps, table=tbl,
        read_ix=surv_ix,
        names=[names[r] for r in surv_ix],
        weights=weight[surv_ix],
        unmapped=unmapped[surv_ix],
        c_read=surv_pos[cand["read"]],
        c_hap=cand["hap"], c_prob=cand["prob"],
        c_mid1=cand["mid1"], c_mid2=cand["mid2"],
        c_a1=cand["a1"], c_a2=cand["a2"],
        used_mask=used_mask)
    yield result, stats
